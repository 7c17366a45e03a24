"""Embedding service client + LRU cache.

Parity with the reference (embedding.go + embedding_cache.go) and with the
JAX package's ``server/embedding.py``: batched POST to
`http://{ollama_server}/api/embed` with `{"model", "input": [texts]}` parsing
`{"embeddings": [[...]]}` (embedding.go:50-104); a 100-entry LRU consulted and
populated only when use_cache=True (searches cache, inserts don't —
embedding.go:29-48, rest.go:262, 441); and the module-level function variable
`embed_text` as the swappable seam for tests and mocks (embedding.go:24).
Standard library only.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Callable, List

from . import config

MAX_CACHE_SIZE = 100

EmbedTextFunc = Callable[[List[str], bool], List[List[float]]]


class LRUCache:
    """100-entry mutex-guarded LRU, text -> vector (embedding_cache.go:8-57)."""

    def __init__(self, capacity: int = MAX_CACHE_SIZE):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: OrderedDict[str, List[float]] = OrderedDict()

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key, last=False)
                return self._data[key]
            return None

    def put(self, key: str, value: List[float]) -> None:
        with self._lock:
            if key in self._data:
                self._data[key] = value
                self._data.move_to_end(key, last=False)
                return
            if len(self._data) >= self.capacity:
                self._data.popitem(last=True)
            self._data[key] = value
            self._data.move_to_end(key, last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


embedding_cache = LRUCache()


class EmbeddingError(RuntimeError):
    pass


def embed_text_ollama(texts: List[str], use_cache: bool) -> List[List[float]]:
    """HTTP path to an Ollama server (embedding.go:50-104)."""
    if use_cache:
        cached = [embedding_cache.get(t) for t in texts]
        if all(c is not None for c in cached):
            return cached  # type: ignore[return-value]

    url = config.global_config.ollama_server
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    url = f"{url}/api/embed"
    payload = json.dumps({"model": config.global_config.text_model,
                          "input": texts}).encode()
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
    except urllib.error.URLError as exc:
        raise EmbeddingError(f"failed to connect to Ollama server: {exc}") \
            from exc
    try:
        embeddings = json.loads(body)["embeddings"]
    except (json.JSONDecodeError, KeyError) as exc:
        raise EmbeddingError(f"failed to decode response: {body[:200]!r}") \
            from exc
    if not embeddings:
        raise EmbeddingError("no embeddings found in response")
    if use_cache:
        for t, e in zip(texts, embeddings):
            embedding_cache.put(t, e)
    return embeddings


# The swappable seam (embedding.go:24): tests replace this module-level
# variable.
embed_text: EmbedTextFunc = embed_text_ollama


def set_embed_text(fn: EmbedTextFunc) -> None:
    global embed_text
    embed_text = fn


def get_embed_text() -> EmbedTextFunc:
    return embed_text

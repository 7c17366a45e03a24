"""Hash-based tokenizer for the on-device embedder.

The reference delegates all text -> vector work to an external Ollama server
(embedding.go:50-104) and ships no tokenizer.  For the on-chip embedding path
we need a dependency-free, deterministic tokenizer that works with zero
downloaded assets: lowercased word+punctuation split, each token hashed into
a fixed vocab (feature-hashing).  When a real pretrained checkpoint+vocab is
available the embedder can swap in a transformers tokenizer instead.
"""

from __future__ import annotations

import hashlib
import re
import unicodedata

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT vocab.txt — the tokenizer
    real MiniLM checkpoints ship with (models/hf_loader.py).  Lowercasing +
    whitespace/punctuation pre-split matching BERT's BasicTokenizer
    (do_lower_case), then greedy '##'-continuation matching; tokens that
    cannot be segmented become [UNK].  Output protocol matches
    HashingTokenizer: batch_encode -> (ids, mask) padded to max_len, with
    [CLS] ... [SEP] framing."""

    _MAX_WORD_CHARS = 100

    def __init__(self, vocab: dict[str, int], max_len: int = 128):
        self.vocab = vocab
        self.max_len = max_len
        self.vocab_size = max(vocab.values()) + 1 if vocab else 0
        for tok in ("[CLS]", "[SEP]", "[UNK]", "[PAD]"):
            if tok not in vocab:
                raise ValueError(f"vocab.txt missing special token {tok}")
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.unk_id = vocab["[UNK]"]
        self.pad_id = vocab["[PAD]"]

    @classmethod
    def from_vocab_file(cls, path: str,
                        max_len: int = 128) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, max_len)

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self._MAX_WORD_CHARS:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> list[int]:
        # BasicTokenizer parity (do_lower_case=True): lowercase, then NFD
        # and drop combining marks so accented text matches transformers'
        # BertTokenizer ("café" -> "cafe", not "caf"+UNK — review finding
        # r4).  CJK needs no spacing pass here: the token regex already
        # emits each non-alphanumeric char as its own token, which equals
        # HF's space-around-CJK behavior.
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")
        ids = [self.cls_id]
        for word in _TOKEN_RE.findall(text):
            ids += self._wordpiece(word)
        ids = ids[: self.max_len - 1]
        ids.append(self.sep_id)
        return ids

    def batch_encode(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (B, L) int32, mask (B, L) f32), padded to max_len."""
        batch = [self.encode(t) for t in texts]
        ids = np.full((len(batch), self.max_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(batch), self.max_len), dtype=np.float32)
        for i, seq in enumerate(batch):
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1.0
        return ids, mask


class HashingTokenizer:
    def __init__(self, vocab_size: int = 30522, max_len: int = 128):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _hash(self, token: str) -> int:
        h = hashlib.blake2s(token.encode(), digest_size=8).digest()
        return _RESERVED + int.from_bytes(h, "little") % (self.vocab_size -
                                                          _RESERVED)

    def encode(self, text: str) -> list[int]:
        tokens = _TOKEN_RE.findall(text.lower())
        ids = [CLS_ID] + [self._hash(t) for t in tokens]
        return ids[: self.max_len]

    def batch_encode(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (B, L) int32, mask (B, L) f32), padded to max_len."""
        batch = [self.encode(t) for t in texts]
        ids = np.full((len(batch), self.max_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(batch), self.max_len), dtype=np.float32)
        for i, seq in enumerate(batch):
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1.0
        return ids, mask

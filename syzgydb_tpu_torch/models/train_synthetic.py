"""The synthetic topical corpus of the on-device embedder and its retrieval
gate.

The repo has no pretrained weights, so the shipped checkpoint
(DEFAULT_CHECKPOINT) was trained contrastively on a synthesized corpus
with a planted similarity structure:

* A vocabulary of random word strings is partitioned into TOPICS plus a
  shared filler pool.  A "document" samples mostly same-topic words plus
  filler; a positive pair is two independent documents from one topic.
* The retrieval gate embeds held-out query documents against a candidate
  set with one same-topic document each: top-1 accuracy must clear 0.9 for
  the trained checkpoint and stays below 0.5 for random weights
  (tests/test_torch_embedder.py pins both).

The same seeds give the same documents as the JAX package's module.  The
contrastive training loop (train, main) is not ported yet (ROADMAP.md
Queue 1).  Servers get the checkpoint with `embedder: device` +
`embedder_checkpoint: <path>` (syzgy.conf).
"""

from __future__ import annotations

import os
import string

import numpy as np

# a byte-identical copy of the JAX package's checkpoint: the port reads
# only its own directory
DEFAULT_CHECKPOINT = os.path.join(os.path.dirname(__file__), "checkpoints",
                                  "synthetic_minilm.ckpt")

N_TOPICS = 64
WORDS_PER_TOPIC = 24
N_FILLER = 256


def _words(rng: np.random.Generator, n: int) -> list[str]:
    letters = np.array(list(string.ascii_lowercase))
    out = []
    for _ in range(n):
        ln = int(rng.integers(3, 9))
        out.append("".join(rng.choice(letters, size=ln)))
    return out


def make_vocab(seed: int = 1234):
    """(topic word lists, shared filler words) -- deterministic."""
    rng = np.random.default_rng(seed)
    words = _words(rng, N_TOPICS * WORDS_PER_TOPIC + N_FILLER)
    topics = [words[i * WORDS_PER_TOPIC:(i + 1) * WORDS_PER_TOPIC]
              for i in range(N_TOPICS)]
    filler = words[N_TOPICS * WORDS_PER_TOPIC:]
    return topics, filler


def sample_doc(rng: np.random.Generator, topic_words: list[str],
               filler: list[str]) -> str:
    """6-16 words, ~2/3 from the topic, rest filler, shuffled."""
    n = int(rng.integers(6, 17))
    n_topic = max(2, (2 * n) // 3)
    ws = list(rng.choice(topic_words, size=n_topic)) + \
        list(rng.choice(filler, size=n - n_topic))
    rng.shuffle(ws)
    return " ".join(ws)


def training_config():
    """The shipped checkpoint's config: small, f32."""
    from .embedder import EmbedderConfig
    return EmbedderConfig(vocab_size=8192, hidden=128, layers=2, heads=4,
                          mlp_dim=512, max_len=64, dtype="float32")


def retrieval_accuracy(embedder, seed: int = 777, n_queries: int = 64,
                       n_candidates: int = 256) -> float:
    """Held-out gate: each query document must retrieve the ONE candidate
    sharing its topic, top-1 by cosine, among distractors from other
    topics."""
    topics, filler = make_vocab()
    rng = np.random.default_rng(seed)
    hits = 0
    cand_topics = rng.permutation(N_TOPICS)[: min(N_TOPICS, n_candidates)]
    cands = [sample_doc(rng, topics[t], filler) for t in cand_topics]
    zc = embedder.embed(cands)
    for _ in range(n_queries):
        pos = int(rng.integers(0, len(cand_topics)))
        q = sample_doc(rng, topics[cand_topics[pos]], filler)
        zq = embedder.embed([q])[0]
        hits += int(np.argmax(zc @ zq) == pos)
    return hits / n_queries

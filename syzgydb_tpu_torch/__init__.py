"""syzgydb_tpu_torch — the PyTorch/CUDA port of syzgydb_tpu.

The same embeddable vector database (SyzgyDB-compatible API and on-disk
format) running on an NVIDIA GPU: quantized vectors live as packed integer
arrays in device memory, exhaustive kNN runs through a hand-written
segment-min CUDA kernel with a provable fp32 rerank, radius search
escalates through the same scan (or a hand-written full-surface kernel past
its bounds), the ANN path ranks sign sketches with a hand-written Hamming
kernel, and metadata query strings filter every mode.  The JAX package
``syzgydb_tpu`` is the reference; this package imports nothing of it.

Entry points run on CUDA unless the caller asks for the CPU
(``Collection(options, device="cpu")``).
"""

from .core.collection import (
    COSINE,
    EUCLIDEAN,
    Collection,
    CollectionOptions,
    CollectionStats,
    Document,
    FilterFn,
    SearchArgs,
    SearchResult,
    SearchResults,
)
from .utils.rng import MyRandom, my_random

__version__ = "0.1.0"

__all__ = [
    "Collection", "CollectionOptions", "CollectionStats", "Document",
    "SearchArgs", "SearchResult", "SearchResults", "FilterFn",
    "EUCLIDEAN", "COSINE", "MyRandom", "my_random", "build_filter",
]


def build_filter(query_str: str) -> FilterFn:
    """Compile a metadata query string into a FilterFn (collection.go:204-218).

    Records whose filter evaluation errors are rejected (logged through the
    query engine's logger)."""
    import logging

    from .query import filter_function_from_query
    fn = filter_function_from_query(query_str)

    def filt(doc_id: int, metadata: bytes) -> bool:
        try:
            return fn(metadata)
        except Exception as exc:  # reference logs & rejects (collection.go:209-214)
            logging.getLogger("syzgydb.query").warning(
                "Error applying filter to document %d: %s", doc_id, exc)
            return False

    return filt

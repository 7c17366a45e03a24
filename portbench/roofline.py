"""Peaks of the card and the least work of a search.

NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s in bf16, 3.35 TB/s
of HBM.  The least time of a piece of work is the larger of its
operations at the bf16 rate and its bytes at the memory rate.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_S)


def scan_work(*, queries: int, rows: int, dims: int, bits: int,
              results: int) -> tuple[float, float]:
    """(operations, bytes) of an exhaustive search of `queries` queries
    over `rows` stored rows: one multiply-add per query, row and
    dimension; the codes, the rows' f32 norms and the f32 queries read
    once, and each query's `results` (f32 distance, int64 row) written
    once.  Whatever implements the search, this is the work it needs."""
    ops = 2.0 * queries * rows * dims
    nbytes = (rows * dims * bits / 8.0 + rows * 4.0 + queries * dims * 4.0
              + queries * results * 12.0)
    return ops, nbytes

"""Sign-projection Hamming index (the port of
``syzgydb_tpu/index/hamming.py``).

Every vector is encoded once into `tables * bits_per_table` hyperplane
sign bits packed into 32-bit words (LSB-first).  A query is ranked against
all N sketches by Hamming distance — kernel K2 (ops/hamming_scan.py) — and
the `budget` best rows are reranked exactly; PercentSearched = budget / N.
Euclidean hashing adds data-calibrated offsets (median projection of a
sample).

Planes come from the same ``MyRandom`` stream as the JAX package, so the
same ``index_seed`` gives bit-identical planes and sketches.  Sketch words
are uint32 values carried in int32 tensors on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import distance as dist_ops
from ..ops import hamming_scan
from ..ops import quantize as qz
from ..utils.rng import MyRandom

DEFAULT_TABLES = 5
DEFAULT_BITS_PER_TABLE = 32
# kept from the JAX package (whose TPU path carries sketch distances in a
# uint8 surface with 255 reserved): collections stay portable both ways
MAX_TOTAL_BITS = 254


def check_index_shape(tables: int, bits_per_table: int) -> None:
    """Validate index knobs; raises ValueError with an explanation."""
    if tables < 1 or bits_per_table < 1:
        raise ValueError("index_tables and index_bits_per_table must be >= 1")
    total = tables * bits_per_table
    if total % 32 != 0:
        raise ValueError(
            f"index_tables * index_bits_per_table must be a multiple of 32 "
            f"(got {total})")
    if total > MAX_TOTAL_BITS:
        raise ValueError(
            f"index_tables * index_bits_per_table must be <= "
            f"{MAX_TOTAL_BITS} (got {total}): sketch distances ride a uint8 "
            f"surface with 255 reserved for invalid rows")


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(N, total_bits) bool -> (N, words) uint32, LSB-first within a word."""
    n, total = bits.shape
    words = total // 32
    shaped = bits.reshape(n, words, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (shaped * weights[None, None, :]).sum(axis=-1, dtype=np.uint32)


def _encode_device(vectors: torch.Tensor, planes: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """(N, D) f32 -> (N, words) int32 packed sign bits.  Full fp32 (never
    TF32): sign bits near a hyperplane must not depend on whether a vector
    was sketched on the host or the device."""
    with dist_ops.full_f32():
        proj = vectors @ planes
    bits = (proj - offsets[None, :]) > 0.0
    n, total = bits.shape
    shaped = bits.reshape(n, total // 32, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device))
    packed = (shaped * weights).sum(dim=-1)
    # uint32 pattern -> the int32 with the same bits
    packed = packed - ((packed >> 31) & 1) * (1 << 32)
    return packed.to(torch.int32)


def _dequantize_device(codes: torch.Tensor, bits: int,
                       dims: int) -> torch.Tensor:
    """Device codes -> (N, D) f32 dequantized vectors, in the JAX
    package's f32 operation order (value * scale + offset)."""
    vals = dist_ops.decode_codes(codes, bits, dims)
    if bits in (32, 64):
        return vals
    scale, offset = qz.affine_constants(bits)
    return vals * scale + offset


def hamming_candidates(qcodes: torch.Tensor, db_hashes: torch.Tensor,
                       valid: torch.Tensor, budget: int):
    """Top-`budget` rows by Hamming distance of packed sketches ->
    (distances, rows), both (Q, budget).  The surface is kernel K2 in bf16
    (every count, and 16384, is exact in it: half the f32 surface's
    bytes); the selection is an exact torch.topk (the JAX package selects
    with approx_min_k at recall_target 0.95, so the port may pick better
    candidates, never worse)."""
    ham = hamming_scan.hamming_scores(qcodes, db_hashes, valid,
                                      out_dtype=torch.bfloat16)
    vals, idx = torch.topk(ham, budget, dim=1, largest=False, sorted=False)
    return vals, idx


def rerank_topk(queries: torch.Tensor, codes: torch.Tensor,
                norms: torch.Tensor, valid: torch.Tensor, cand: torch.Tensor,
                bits: int, metric: str, k: int, with_counts: bool = False):
    """Exact fp32 distances on gathered candidates, then top-k.

    queries (Q, D) f32; cand (Q, C) int64 rows into codes/norms.  Returns
    (dist (Q, k) f32 ascending, rows (Q, k)), ties ordered by row; with
    with_counts=True appends nscored (Q,) int32, the number of VALID
    candidates scored per query (the visited-points figure for
    PercentSearched)."""
    nq, c = cand.shape
    flat = cand.reshape(-1)
    ccodes = codes.index_select(0, flat).reshape((nq, c) + codes.shape[1:])
    cnorms = norms.index_select(0, flat).reshape(nq, c)
    cvalid = valid.index_select(0, flat).reshape(nq, c)
    dots = dist_ops.candidate_dots(queries, ccodes, bits)
    if metric == "euclidean":
        qn = queries.square().sum(dim=-1, keepdim=True)
        dist = (qn - 2.0 * dots + cnorms).clamp_min(0.0).sqrt()
    else:
        dist = dist_ops.angular_from_dots(queries, dots, cnorms)
    dist = torch.where(cvalid, dist, torch.full_like(dist, np.inf))
    vals, rows = dist_ops.sort_topk(dist, cand, min(k, c))
    if with_counts:
        return vals, rows, cvalid.sum(dim=1).to(torch.int32)
    return vals, rows


class SignHashIndex:
    """Host-side owner of the projection planes and calibration state."""

    def __init__(self, dims: int, metric: str, rng: MyRandom,
                 tables: int = DEFAULT_TABLES,
                 bits_per_table: int = DEFAULT_BITS_PER_TABLE):
        check_index_shape(tables, bits_per_table)
        self.dims = dims
        self.metric = metric
        self.tables = tables
        self.bits_per_table = bits_per_table
        self.total_bits = tables * bits_per_table
        self.words = self.total_bits // 32
        planes = rng.standard_normal((dims, self.total_bits))
        planes /= np.linalg.norm(planes, axis=0, keepdims=True)
        self.planes = np.float32(planes)
        self.offsets = np.zeros((self.total_bits,), dtype=np.float32)
        self.calibrated = metric != "euclidean"  # cosine: origin planes, done
        self._rng = rng

    # -- encoding ----------------------------------------------------------

    def encode_np(self, vectors: np.ndarray) -> np.ndarray:
        """Host path for single/few vectors -> (N, words) uint32."""
        v = np.atleast_2d(np.float32(vectors))
        proj = v @ self.planes
        return _pack_bits_np((proj - self.offsets[None, :]) > 0.0)

    # rows per sketch-encode step: bounds the (chunk, D) f32 dequant
    # transient
    ENCODE_CHUNK_ROWS = 1 << 20

    def encode_codes_device(self, device_codes: torch.Tensor,
                            bits: int) -> torch.Tensor:
        """Encode directly from the device-resident quantized codes:
        dequantize, project, pack — chunked to bound the f32 transient.
        Returns (N, words) int32 on the codes' device."""
        dev = device_codes.device
        planes = torch.from_numpy(self.planes).to(dev)
        offsets = torch.from_numpy(self.offsets).to(dev)
        step = self.ENCODE_CHUNK_ROWS
        return torch.cat([
            _encode_device(_dequantize_device(device_codes[s:s + step], bits,
                                              self.dims), planes, offsets)
            for s in range(0, max(device_codes.shape[0], 1), step)], dim=0)

    # -- calibration -------------------------------------------------------

    def calibrate(self, sample_vectors: np.ndarray) -> None:
        """Set per-plane offsets to the median projection of a data sample
        (euclidean only)."""
        if self.metric != "euclidean":
            return
        proj = np.float32(np.atleast_2d(sample_vectors)) @ self.planes
        self.offsets = np.float32(np.median(proj, axis=0))
        self.calibrated = True

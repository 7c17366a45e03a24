"""Distance functions (the PyTorch port's counterpart of
``syzgydb_tpu/ops/distance.py``).

Semantics match the SyzgyDB Go reference exactly (collection.go:812-832):

* euclidean(a, b) = sqrt(sum((a-b)^2))
* "cosine" is angular distance: acos(cos_sim) / pi in [0, 1], and 1.0 if either
  vector is a zero vector.  (The cosine argument is clamped to [-1, 1] before
  acos; the Go version can produce NaN when f64 rounding pushes the ratio
  epsilon above 1 — we deliberately clamp instead, documented deviation.)

The host half (numpy, float64) is a verbatim copy of the JAX package's.  The
device half holds the reranks' helpers: fp32 contractions of queries with
gathered *centered integer codes* (see ops/quantize.py), the reference
angular distance, and the (value, row) top-k order.  With
dequant(c) = s * c + o:

    dot(q, v)   = s * (q @ c^T) + o * sum(q)
    ||v||^2     = precomputed at ingest (f32, per row)
    euclid^2    = ||q||^2 - 2 dot + ||v||^2
    cos_sim     = dot / (||q|| * ||v||)

Every fp32 product of the port runs under ``full_f32()``: TF32 keeps ~10
mantissa bits, which is exact for no code width wider than 8 bits and would
void the completeness flag's error bound (the port's form of the JAX
package's wide-code invariant, ops/distance.py:321-356 there).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Literal

import numpy as np
import torch

from . import quantize as qz

Metric = Literal["euclidean", "cosine"]
VALID_METRICS = ("euclidean", "cosine")


# ---------------------------------------------------------------------------
# Host (numpy, float64) — exactness oracle, mirrors the Go scalar loops
# ---------------------------------------------------------------------------

def euclidean_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise euclidean distance. a: (..., D), b: (..., D) broadcastable."""
    diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.sqrt(np.sum(diff * diff, axis=-1))


def angular_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise angular distance (reference 'cosine'), collection.go:821-832."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    dot = np.sum(a * b, axis=-1)
    m1 = np.sum(a * a, axis=-1)
    m2 = np.sum(b * b, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cos = dot / (np.sqrt(m1) * np.sqrt(m2))
    dist = np.arccos(np.clip(cos, -1.0, 1.0)) / np.pi
    return np.where((m1 == 0) | (m2 == 0), 1.0, dist)


def distance_np(a: np.ndarray, b: np.ndarray, metric: Metric) -> np.ndarray:
    if metric == "euclidean":
        return euclidean_np(a, b)
    if metric == "cosine":
        return angular_np(a, b)
    raise ValueError(f"unknown metric {metric!r}")


# ---------------------------------------------------------------------------
# Device (jnp) — batched scoring over the packed representation
# ---------------------------------------------------------------------------

_SQ_TABLES: dict[int, np.ndarray] = {}


def _sq_table(bits: int) -> np.ndarray:
    """dequantize(code)^2 for every code value — f64, computed with the
    exact reference dequant chain so a table gather + sum is bit-identical
    to the dequant + square + sum it replaces."""
    tab = _SQ_TABLES.get(bits)
    if tab is None:
        codes = np.arange(1 << bits, dtype=np.uint64)
        v = qz.dequantize_np(codes, bits)
        tab = _SQ_TABLES[bits] = v * v
    return tab


def db_row_stats(device_codes: np.ndarray, bits: int,
                 dims: int | None = None) -> np.ndarray:
    """Per-row squared norm of the *dequantized* vectors, f32 (N,).

    Computed host-side once per ingested batch; uploaded alongside the codes.
    Chunked to keep the working set small (see quantize._CHUNK_ROWS).
    `dims` is required for 4-bit (packed device codes).

    8/16-bit ride a squared-value lookup table (one gather + one sum
    instead of the ~6-temporary dequant chain; same f64 values and
    summation order, so the output is bit-identical — the reopen/ingest
    hot path at config5 scale)."""
    device_codes = np.atleast_2d(device_codes)
    n = device_codes.shape[0]
    out = np.empty((n,), dtype=np.float32)
    step = qz._CHUNK_ROWS
    if bits == 8:
        tab, raw, flip = _sq_table(8), device_codes.view(np.uint8), 0x80
    elif bits == 16:
        tab, raw, flip = _sq_table(16), device_codes.view(np.uint16), 0x8000
    else:
        tab = raw = flip = None
    for s in range(0, n, step):
        if tab is not None:
            # XOR per chunk: a whole-matrix index temporary would defeat
            # the chunking
            out[s:s + step] = np.sum(tab[raw[s:s + step] ^ flip], axis=-1)
        else:
            v = qz.device_repr_to_float(device_codes[s:s + step], bits, dims)
            out[s:s + step] = np.sum(v * v, axis=-1)
    return out


def ingest_reprs(vectors: np.ndarray, bits: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One quantize pass -> (storage bytes, host column codes, row stats).

    Fuses pack_vectors + codes_to_host_repr + db_row_stats for the bulk
    ingest path: all three derive from the same quantized codes, and the
    duplicate quantize/dequant passes were ~55% of the host-side ingest
    cost at config5 scale (50k x 384 x 8-bit: 1081 -> ~420 ms).  Every
    output is bit-identical to the unfused calls (the centered device code
    is the unsigned storage code with its sign bit flipped, and the norm
    uses the reference f64 dequant formula on the SAME codes) — pinned by
    tests/test_quantize.py.  Chunked like the unfused paths (first-touch
    page faults dominate on single-core hosts, quantize._CHUNK_ROWS)."""
    qz._check_bits(bits)
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
    n, dims = vectors.shape
    packed = np.empty((n, qz.vector_byte_size(bits, dims)), np.uint8)
    host = np.array(vectors, dtype=np.float64) if bits == 64 else \
        np.empty((n, qz.device_width(bits, dims)), qz.host_dtype(bits))
    norms = np.empty(n, np.float32)
    step = qz._CHUNK_ROWS
    for s in range(0, n, step):
        chunk = vectors[s:s + step]
        m = chunk.shape[0]
        if bits == 64:
            packed[s:s + step] = chunk.view(np.uint64).astype(
                ">u8").view(np.uint8).reshape(m, -1)
            v = chunk
        elif bits == 32:
            f32 = np.asarray(chunk, dtype=np.float32)
            packed[s:s + step] = f32.view(np.uint32).astype(
                ">u4").view(np.uint8).reshape(m, -1)
            host[s:s + step] = f32
            v = f32.astype(np.float64)
        else:  # 4 / 8 / 16: integer codes
            # quantize_np without the uint64 round-trip: f64 holds the
            # integral codes exactly, and each op below rounds identically
            # to the (clamped+1)/2*maxint, floor(x+.5), codes/maxint*2-1
            # reference chain — see test_ingest_reprs_parity
            maxint = float(qz._MAXINT[bits])
            q = np.clip(chunk, -1.0, 1.0)
            q += 1.0
            q *= maxint / 2.0
            q += 0.5
            np.floor(q, out=q)
            if bits == 4:
                padded = np.zeros((m, dims + (dims % 2)), np.uint8)
                padded[:, :dims] = q.astype(np.uint8)
                pk = (padded[:, 0::2] << 4) | (padded[:, 1::2] & 0x0F)
                packed[s:s + step] = pk
                host[s:s + step] = pk  # packed nibbles ARE the device repr
            elif bits == 8:
                pk = q.astype(np.uint8)
                packed[s:s + step] = pk
                # (code-128) over [0,255] == flip the top bit, reread signed
                host[s:s + step] = (pk ^ 0x80).view(np.int8)
            else:  # 16
                pk = q.astype(np.uint16)
                packed[s:s + step] = pk.astype(
                    ">u2").view(np.uint8).reshape(m, -1)
                host[s:s + step] = (pk ^ 0x8000).view(np.int16)
            q /= maxint
            q *= 2.0
            q -= 1.0
            v = q
        norms[s:s + step] = np.sum(v * v, axis=-1)
    return packed, host, norms


# the TF32 switch is process-wide: concurrent searches must not restore a
# caller's TF32 setting while another thread is launching its product
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_f32():
    """Run the enclosed fp32 products at full fp32 precision on the GPU
    (``torch.backends.cuda.matmul.allow_tf32 = False``), restoring the
    caller's setting afterwards."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def split_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed 4-bit codes (..., P) uint8 -> centered (high, low) f32 in
    [-8, 7].  High nibble = even dims, low = odd dims (disk nibble order,
    collection.go:727-731)."""
    p = packed.to(torch.int32)
    return ((p >> 4) - 8).to(torch.float32), ((p & 0xF) - 8).to(torch.float32)


def decode_codes(codes: torch.Tensor, bits: int, dims: int) -> torch.Tensor:
    """(..., W) device codes -> (..., D) f32 values of the centered code
    (4/8/16-bit; dequant = scale * value + offset) or the raw f32 value
    (32/64-bit).  4-bit unpacks the nibbles back to dim order."""
    if bits == 4:
        h, low = split_nibbles(codes)
        both = torch.stack([h, low], dim=-1)
        return both.reshape(codes.shape[:-1] + (-1,))[..., :dims]
    return codes.to(torch.float32)


def affine_dots(queries: torch.Tensor, raw: torch.Tensor, bits: int):
    """Raw code contraction -> true dot products (affine dequantization)."""
    if bits in (32, 64):
        return raw
    scale, offset = qz.affine_constants(bits)
    return scale * raw + offset * queries.sum(dim=-1, keepdim=True)


def packed4_dots_batched(queries: torch.Tensor,
                         ccodes: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x (Q, C, P) packed uint8 -> (Q, C) f32 per-candidate dots."""
    qe, qo = queries[:, 0::2], queries[:, 1::2]
    h, low = split_nibbles(ccodes)
    with full_f32():
        raw = torch.einsum("qd,qcd->qc", qe, h) + \
            torch.einsum("qd,qcd->qc", qo, low[..., : qo.shape[1]])
    return affine_dots(queries, raw, 4)


def candidate_dots(queries: torch.Tensor, ccodes: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """(Q, D) f32 x gathered (Q, C, D|P) codes -> (Q, C) f32 true dots,
    full fp32 at every width (the reranks' contraction)."""
    if bits == 4:
        return packed4_dots_batched(queries, ccodes)
    with full_f32():
        raw = torch.einsum("qd,qcd->qc", queries, ccodes.to(torch.float32))
    return affine_dots(queries, raw, bits)


def angular_from_dots(queries: torch.Tensor, dots: torch.Tensor,
                      row_norms: torch.Tensor) -> torch.Tensor:
    """Reference angular distance from true dots; zero query or zero row ->
    1.0 (collection.go:828-829).  row_norms broadcasts against dots."""
    qn = queries.square().sum(dim=-1, keepdim=True).sqrt()
    vn = row_norms.sqrt()
    denom = qn * vn
    cos = torch.where(denom > 0.0, dots / torch.where(denom > 0.0, denom,
                                                      torch.ones_like(denom)),
                      torch.ones_like(dots))
    dist = torch.acos(cos.clamp(-1.0, 1.0)) / np.pi
    return torch.where((qn == 0.0) | (vn == 0.0), torch.ones_like(dist), dist)


def sort_topk(dist: torch.Tensor, rows: torch.Tensor, k: int):
    """The k smallest of each row of dist, ordered by (value, row) — a
    deterministic order at tied values, where torch.topk promises none.
    rows (same shape as dist) names each column's row id."""
    by_row = torch.argsort(rows, dim=1, stable=True)
    d = torch.gather(dist, 1, by_row)
    r = torch.gather(rows, 1, by_row)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, order), torch.gather(r, 1, order)

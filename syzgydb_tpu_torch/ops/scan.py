"""Exhaustive scans: the wrappers of kernels K1 and K5/K6 (segment minima;
``csrc/segmin_i8.cu`` for 8- and 16-bit codes, ``csrc/segmin.cu`` for the
other widths) and K4 (the full surface; ``csrc/segmin_i8.cu`` for 8-bit
codes, ``csrc/surface.cu`` for the other widths), their plain PyTorch
versions, and the provable select-and-rerank stage — the port of
``syzgydb_tpu/ops/pallas_scan.py``.  ``_route`` is the one dispatch rule.

Two phases, as in the JAX package:

  1. **Kernel K1** streams the codes once and writes, per query, the
     minimum surrogate distance of every SEG-row segment: a (Q, N/SEG) f32
     surface instead of the (Q, N) distance matrix.  The fp32 kernel at
     SEG in {16, 64, 128} is the port of the archived TPU layouts K5/K6.
  2. **Select and rerank**: the S = k + margin best segments are gathered
     contiguously and reranked in full fp32; a per-query flag proves that
     the k results are the true f32 top-k (EXACTNESS note on
     ``fused_scan_topk`` in the JAX package), otherwise Collection
     re-dispatches with a wider margin.

Past the fused scan's bound on k (``fused_k_ok``) the non-fused selection
(``surface_topk``) takes the kk + margin best rows of kernel K4's full
(Q, N) f32 surface, reranks them with the same formula and keeps the kk
best, with a flag that proves the cut as the fused scan's does; query
chunks and rerank pieces keep it within a memory budget.

Ranking uses a MONOTONIC SURROGATE of the metric (squared euclidean;
(1-cos)/2 for angular); the exact transform is applied after the rerank.

The port keeps the outputs, not the TPU layouts: there is no
segment-interleaved transposed operand, no 128-lane slab and no lean
placement.  K1 reads the row-major (N, W) codes, and its minima are f32 at
every width, so the f32-surface tie margin (6) applies to high and exact
alike.  A CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain version.  The fp32 kernels run at a query tile sized to the batch
(fp32_query_tile: 16, 32, 64 or 128 queries), the same sums in the same
order at every tile.  The int8 route (K1, K5/K6 and K4 on 8-bit codes; K1
and K5/K6 on 16-bit codes, each code split into a high and a low byte)
multiplies int8 slices of the query (slice_queries) on tensor cores, so its
surfaces also carry the slicing error dq_rel, which the flags' bound
(surface_delta) takes wherever that route ran (fused_scan_topk and
surface_topk alike).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from . import distance as dist_ops
from . import quantize as qz

DEFAULT_SEG = 32
MAX_FUSED_K = 128
# large-k dispatches (radius escalation asks for up to 1024) may still
# ride the fused path when Q*k stays within this budget — kept from the
# JAX package so both route the same shapes to the fused scan
_FUSED_K_BUDGET = 1 << 16


def fused_k_ok(k: int, n_queries: int) -> bool:
    """Whether (k, Q) fits the fused scan: the standard serving bound, or
    a small-batch large-k dispatch within the gather budget."""
    return k <= MAX_FUSED_K or \
        (k <= 1024 and max(1, n_queries) * k <= _FUSED_K_BUDGET)


# extra segments gathered beyond k: the JAX package's margin for f32
# surfaces (no storage collisions); a failure escalates to the 64 rung.  K1
# always writes f32 minima, so this is the port's only default.
DEFAULT_TIE_MARGIN = 6


# rerank working set per dispatch chunk: the gathered candidates' f32
# decode.  Chunking the query batch bounds the escalation gather, which
# grows with Q*(k+margin+1)*SEG rows (~103 GB at Q=1024, rung 8192,
# D=384 unchunked); every chunk returns the rows and flags it would in
# one piece.
GATHER_BUDGET_BYTES = 1 << 30

# segment lengths the CUDA segment-min kernel is built for
KERNEL_SEGS = (16, 32, 64, 128)

# plain-integer counters (reset by callers): each kernel's count of
# launches by either route, of those by its int8 route, the (query, row)
# pairs the scans score on every route, the plain one included, and the
# rerank's rows
launches = 0              # K1: segment minima at DEFAULT_SEG
i8_launches = 0
free_seg_launches = 0     # K5/K6: segment minima at seg 16, 64 or 128
i8_free_seg_launches = 0
i8_hilo_launches = 0      # segmin_i8_launch calls on 16-bit codes (K1, K5/K6)
surface_launches = 0      # K4: the full surface
i8_surface_launches = 0
pairs_scored = 0          # Q * N summed over K1, K4 and K5/K6 scans
rerank_rows = 0           # candidate rows decoded and reranked

# the int8 route: query slices (the S csrc/segmin_i8.cu is built for), and
# the widest D whose int32 slice sums cannot overflow
# (|sum| <= 127 * 128 * Kp < 2^31); the widest 16-bit rows it takes are
# the kernel's to say (hilo_max_dims)
I8_SLICES = 3
I8_MAX_DIMS = 1 << 17
# 16-bit K1 and K5/K6 batches of at most I8_HILO_SMALL_Q queries (the fp32
# kernels' smallest query tile) on rows narrower than I8_HILO_SMALL_Q_DIMS
# take the fp32 kernels: both stream the codes there, and the int8 form's
# cost a row that does not scale with D (its int64 combine and epilogue)
# outweighs its cheaper products.  fp32 over int8 time at 1M rows, Q 1-16,
# on the H100: 0.70-0.75 at D = 128, 0.95-0.97 at 384, 0.99-1.01 at 512,
# 1.03-1.08 at 640-960; past Q = 16 the int8 form is 1.0-2.2x faster at
# every D.
I8_HILO_SMALL_Q = 16
I8_HILO_SMALL_Q_DIMS = 512

_CODE_DTYPES = {4: torch.uint8, 8: torch.int8, 16: torch.int16,
                32: torch.float32, 64: torch.float32}


# ---------------------------------------------------------------------------
# K1: segment-min surface
# ---------------------------------------------------------------------------

def _surrogate_plain(qx, qn2, qsum, codes, norms, valid, *, bits: int,
                     metric: str, dims: int, dtype):
    """(Q, B) surrogate surface of one row block in `dtype`, invalid rows
    +inf: the arithmetic every kernel of this module runs, in plain
    PyTorch."""
    if bits in (4, 8, 16):
        scale, offset = qz.affine_constants(bits)
    else:
        scale, offset = 1.0, 0.0
    c = dist_ops.decode_codes(codes, bits, dims).to(dtype)
    with dist_ops.full_f32():
        raw = qx @ c.T
    return surrogate(qn2, scale * raw + offset * qsum, norms.to(dtype),
                     valid, metric)


def surrogate(qn2, dots, norms, valid, metric: str):
    """The surface's epilogue: (Q, B) true dots -> the surrogate (squared
    euclidean, or (1 - cos)/2 through rsqrt), invalid rows +inf; qn2 is
    (Q, 1)."""
    nv = norms[None, :]
    if metric == "euclidean":
        s = (qn2 - 2.0 * dots + nv).clamp_min(0.0)
    else:
        den = qn2 * nv
        inv = torch.rsqrt(torch.where(den > 0.0, den, torch.ones_like(den)))
        cos = torch.where(den > 0.0, dots * inv, torch.full_like(dots, -1.0))
        s = (1.0 - cos.clamp(-1.0, 1.0)) * 0.5
    return torch.where(valid[None, :], s, torch.full_like(s, np.inf))


def _plain_blocks(queries, seg: int, dtype, block_rows: int,
                  query_terms=None):
    """(qx, qn2, qsum, step) for a plain version walking the rows in blocks
    of whole segments (the blocks bound the (Q, block) transients).
    `query_terms` = (qn2, qsum) replaces the queries' own."""
    qx = queries.to(dtype)
    if query_terms is None:
        qn2 = qx.square().sum(dim=-1, keepdim=True)
        qsum = qx.sum(dim=-1, keepdim=True)
    else:
        qn2, qsum = (t.to(dtype)[:, None] for t in query_terms)
    return qx, qn2, qsum, max(seg, block_rows // seg * seg)


def segment_min_scan_plain(queries, codes, norms, valid, *, bits: int,
                           metric: str, seg: int = DEFAULT_SEG,
                           dtype=torch.float32, block_rows: int = 1 << 17,
                           query_terms=None):
    """Plain version of K1/K5/K6 in `dtype` (float32, or float64 as an
    exact reference): one full-precision product of the decoded codes per
    row block, the surrogate epilogue, and a reshape-min over each
    segment.  `query_terms` = (qn2 (Q,), qsum (Q,)) stand in for those of
    `queries`: evaluated on the int8 route's q_hat with the unrounded
    query's terms, this is that route's arithmetic done exactly."""
    q, d = queries.shape
    n = codes.shape[0]
    qx, qn2, qsum, step = _plain_blocks(queries, seg, dtype, block_rows,
                                        query_terms)
    out = torch.empty((q, n // seg), dtype=dtype, device=codes.device)
    for a in range(0, n, step):
        s = _surrogate_plain(qx, qn2, qsum, codes[a:a + step],
                             norms[a:a + step], valid[a:a + step], bits=bits,
                             metric=metric, dims=d, dtype=dtype)
        out[:, a // seg:(a + s.shape[1]) // seg] = \
            s.reshape(q, -1, seg).amin(dim=-1)
    return out


def score_surface_plain(queries, codes, norms, valid, *, bits: int,
                        metric: str, exact: bool = False, dtype=None,
                        block_rows: int = 1 << 17, query_terms=None):
    """Plain version of K4: the (Q, N) surrogate surface, invalid rows
    +inf, computed in f32 (or `dtype`, e.g. float64 as an exact reference)
    and returned in f32 when `exact`, else rounded to bf16.  `query_terms`
    as segment_min_scan_plain's."""
    q, d = queries.shape
    n = codes.shape[0]
    work = torch.float32 if dtype is None else dtype
    qx, qn2, qsum, step = _plain_blocks(queries, 1, work, block_rows,
                                        query_terms)
    out_t = work if (exact or dtype is not None) else torch.bfloat16
    out = torch.empty((q, n), dtype=out_t, device=codes.device)
    for a in range(0, n, step):
        out[:, a:a + step] = _surrogate_plain(
            qx, qn2, qsum, codes[a:a + step], norms[a:a + step],
            valid[a:a + step], bits=bits, metric=metric, dims=d, dtype=work)
    return out


def _check_scan_args(queries, codes, norms, valid, bits, seg):
    q, d = queries.shape
    n, w = codes.shape
    if codes.dtype != _CODE_DTYPES[bits]:
        raise TypeError(f"{bits}-bit codes must be {_CODE_DTYPES[bits]}, "
                        f"got {codes.dtype}")
    if w != qz.device_width(bits, d):
        raise ValueError(f"codes width {w} does not fit {d}-d {bits}-bit")
    if norms.shape != (n,) or norms.dtype != torch.float32:
        raise ValueError("norms must be an (N,) float32 tensor")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("valid must be an (N,) bool tensor")
    if n % seg:
        raise ValueError(f"N={n} is not a multiple of the segment {seg}")
    if not (queries.device == codes.device == norms.device == valid.device):
        raise ValueError("queries, codes, norms and valid must share a device")


def _kernel_operands(queries, codes, norms, valid, bits):
    """Check contiguity and prepare what the CUDA entry points take: the
    f32 queries zero-padded to K decoded dims (4-bit: K = 2P, so an odd
    D's pad nibble meets a zero), their |q|^2 and sum, and the affine
    dequantization constants."""
    for name, t in (("codes", codes), ("norms", norms), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = queries.shape[1]
    w = codes.shape[1]
    qx = queries.to(torch.float32)
    k_dims = 2 * w if bits == 4 else d
    if k_dims != d:
        qx = torch.nn.functional.pad(qx, (0, k_dims - d))
    qx = qx.contiguous()
    qn2 = qx.square().sum(dim=-1).contiguous()
    qsum = qx.sum(dim=-1).contiguous()
    if bits in (4, 8, 16):
        scale, offset = qz.affine_constants(bits)
    else:
        scale, offset = 1.0, 0.0
    return qx, qn2, qsum, k_dims, scale, offset


# segmin_launch and surface_launch take the same arguments: seven pointers
# (transposed queries, codes, norms, valid, qn2, qsum, out), Q, Qp, N, Kp,
# row_bytes, bits, cosine, scale, offset, then seg (segmin) or out_bf16
# (surface), the query tile, the code copy width and the stream
_SCAN_ENTRY_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# the fp32 kernels' query tiles (csrc/scan_tile.cuh's variants), and the
# multiple of decoded dims the queries are zero-padded to (a stage of
# their tile loop)
FP32_TILES = (16, 32, 64, 128)
FP32_K_PAD = 16


def fp32_query_tile(q: int) -> int:
    """The query tile of the fp32 kernels' launch for Q queries: the
    smallest variant that holds them all, else the largest (Q past 128
    runs ceil(Q / 128) tiles).  A launch computes Q rounded up to a
    multiple of its tile, so Q = 16 computes 16 queries and Q = 17 32."""
    return next((t for t in FP32_TILES if q <= t), FP32_TILES[-1])


def _launch_fp32(name: str, out, last: int, queries, codes, norms, valid, *,
                 bits: int, metric: str, tile=None, defines: tuple = ()):
    """Launch csrc/<name>.cu's fp32 kernel (segmin_launch with `last` =
    seg, surface_launch with `last` = out_bf16) into `out`, at the query
    tile `tile` (None: fp32_query_tile's; every tile gives the same
    output), from the library built with `defines` (() : the shipped one;
    the others are measurement builds)."""
    q = queries.shape[0]
    n, w = codes.shape
    qx, qn2, qsum, k_dims, scale, offset = _kernel_operands(
        queries, codes, norms, valid, bits)
    tile = fp32_query_tile(q) if tile is None else tile
    if tile not in FP32_TILES:
        raise ValueError(f"the fp32 kernels are built for query tiles of "
                         f"{FP32_TILES}, not {tile}")
    # queries transposed (Kp, Qp), zero-padded to whole stages and tiles
    qp = -(-q // tile) * tile
    kp = -(-k_dims // FP32_K_PAD) * FP32_K_PAD
    qt = torch.zeros((kp, qp), dtype=torch.float32, device=codes.device)
    qt[:k_dims, :q] = qx.T
    # code copy width: the widest that divides every row start (the
    # kernel narrows it to a stage's bytes a row)
    row_bytes = w * codes.element_size()
    ptr = codes.data_ptr()
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row_bytes % v == 0 and ptr % v == 0)
    fn = cuda_build.entry(name, f"{name}_launch", _SCAN_ENTRY_ARGTYPES,
                          defines)
    rc = fn(qt.data_ptr(), ptr, norms.data_ptr(), valid.data_ptr(),
            qn2.data_ptr(), qsum.data_ptr(), out.data_ptr(), q, qp, n, kp,
            row_bytes, 32 if bits == 64 else bits,
            int(metric != "euclidean"), scale, offset, last, tile, vec,
            cuda_build.launch_stream(codes.device))
    cuda_build.check(rc, name)


_hilo_max_dims: dict[int, int] = {}


def hilo_max_dims(device) -> int:
    """The widest 16-bit rows (D) the int8 route takes on CUDA `device`, as
    csrc/segmin_i8.cu's resident-slice kernel decides it: the widest whose
    slices (3 x 64 query rows x (Kp + 16) bytes) and two code rings fit a
    block's shared memory, within the low bytes' int32 sums (Kp <= 65,536);
    992 on the H100.  Asked of the kernel library once a device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _hilo_max_dims:
        dims = ctypes.c_int(0)
        fn = cuda_build.entry("segmin_i8", "segmin_i8_hilo_max_dims",
                              [ctypes.POINTER(ctypes.c_int)])
        with torch.cuda.device(idx):
            cuda_build.check(fn(ctypes.byref(dims)), "segmin_i8_hilo_max_dims")
        _hilo_max_dims[idx] = dims.value
    return _hilo_max_dims[idx]


def _route(codes, bits: int, kernel: str, q: int) -> str:
    """Which version of `kernel` ("segmin": K1 and K5/K6; "surface": K4)
    runs on `codes` for `q` queries — this module's one dispatch rule, by
    device, width, kernel and shape:

      * "plain": CPU tensors, the plain PyTorch versions;
      * "i8": the int8 tensor-core route (csrc/segmin_i8.cu), whose outputs
        carry slice_queries' dq_rel: 8-bit codes on CUDA, both kernels, at
        every segment length of KERNEL_SEGS and for K4's f32 and bf16
        surfaces; 16-bit codes on CUDA, K1 and K5/K6 at D <= hilo_max_dims
        (each code split into a high and a low byte in the kernel's load),
        but for batches of at most I8_HILO_SMALL_Q queries on rows narrower
        than I8_HILO_SMALL_Q_DIMS;
      * "fp32": everything else on CUDA, the fp32 kernels (csrc/segmin.cu,
        csrc/surface.cu): 4-, 32- and 64-bit codes, K4 on 16-bit codes,
        16-bit rows past hilo_max_dims, which the int8 route's
        resident-slice kernel cannot hold, and the small 16-bit batches on
        narrow rows above, where the fp32 kernel is the faster.

    Not a fallback: a build or launch failure of the chosen kernel raises,
    and so does a shape it cannot take (D > I8_MAX_DIMS on the int8
    route)."""
    if codes.device.type == "cpu":
        return "plain"
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    d = codes.shape[1]
    if bits == 8 or (bits == 16 and kernel == "segmin" and
                     (q > I8_HILO_SMALL_Q or d >= I8_HILO_SMALL_Q_DIMS) and
                     d <= hilo_max_dims(codes.device)):
        return "i8"
    return "fp32"


def _check_kernel_seg(seg: int) -> None:
    if seg not in KERNEL_SEGS:
        raise ValueError(f"the segment-min kernel is built for segments of "
                         f"{KERNEL_SEGS} rows, not {seg}")


def slice_queries(queries):
    """(Q, D) f32 queries -> (slices int8 (S, Q, Kp), scale f32 (Q,),
    dq_rel f32 (Q,)): the int8 route's query operand.

    q_hat = scale * (a_0 + a_1 2^-7 + a_2 2^-14) with a_s the slices
    (S = I8_SLICES) and Kp = D rounded up to 32, the pad dims zero.  The
    scale is a power of two with max|q_i| / scale <= 127, so |a_0| <= 127;
    each later slice is the round-to-nearest remainder (at most half a
    unit) times 2^7, so |a_s| <= 64 (times 2^8 a half-unit remainder would
    give +128, which int8 lacks).  Every step is exact (done in f64), q_hat
    has at most 22 significant bits and is exact in f32, and dq_rel =
    ||q - q_hat|| / ||q|| (0 for a zero query) is evaluated in f64 and
    rounded up to f32.  Runs on the queries' device."""
    q = queries.to(torch.float32).to(torch.float64)
    nq, d = q.shape
    kp = -(-d // 32) * 32
    m = q.abs().amax(dim=1) if d else q.new_zeros(nq)
    _, e = torch.frexp(m)  # m = f * 2^e, f in [0.5, 1); e = 0 for m = 0
    # 2^(e - 7) > m / 128, built from its bits (exact), kept f32-normal
    e = (e.to(torch.int64) - 7).clamp_min(-126)
    scale = ((e + 1023) << 52).view(torch.float64)
    scale = torch.where(m > 127.0 * scale, 2.0 * scale, scale)
    r = q / scale[:, None]
    parts = []
    for _ in range(I8_SLICES):
        a = torch.round(r)
        parts.append(a)
        r = (r - a) * 128.0
    slices = torch.stack(parts).to(torch.int8)
    if kp != d:
        slices = torch.nn.functional.pad(slices, (0, kp - d))
    # q - q_hat = scale * r * 2^(-7 S), r the last remainder
    num = r.square().sum(dim=1) * (scale * 2.0 ** (-7 * I8_SLICES)).square()
    den = q.square().sum(dim=1)
    dq = torch.where(den > 0.0, torch.sqrt(num / torch.where(
        den > 0.0, den, torch.ones_like(den))), torch.zeros_like(den))
    dq32 = dq.to(torch.float32)
    dq32 = torch.where(dq32.to(torch.float64) < dq, torch.nextafter(
        dq32, torch.full_like(dq32, np.inf)), dq32)
    return slices.contiguous(), scale.to(torch.float32), dq32


def hilo_order(slices):
    """slice_queries' (S, Q, Kp) slices in the K order csrc/segmin_i8.cu's
    16-bit form multiplies them in: within each 32-dim block, slot p holds
    dim (p & 16) + 8 bit1(p) + 2 ((p >> 2) & 3) + bit0(p), the order in
    which one ldmatrix.x4 and a byte permute hand a thread the high (low)
    bytes of its row's codes.  The same permutation of every slice and
    every code leaves each dot unchanged."""
    s, q, kp = slices.shape
    return slices.reshape(s, q, kp // 32, 2, 2, 4, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(s, q, kp).contiguous()


def unslice_queries(slices, scale):
    """q_hat (Q, K) in f64 (exact) from slice_queries' (S, Q, K) slices and
    (Q,) scale."""
    s = slices.to(torch.float64)
    qhat = s[0]
    for i in range(1, s.shape[0]):
        qhat = qhat + s[i] * 2.0 ** (-7 * i)
    return qhat * scale.to(torch.float64)[:, None]


def i8_term_scale(qn2, norms, valid, *, metric: str, dims: int, bits: int):
    """Per-query T such that every f32 rounding of the int8 route's epilogue
    (the raw dot, the f32 affine constants, the products and sums,
    rsqrtf's 2 ulps) errs by at most one f32 ulp of a term bounded by T:
    the route lies within 4 * 2^-24 * T of an exact evaluation of the same
    formula on q_hat with the same qn2 and qsum (segment_min_scan_plain,
    float64, query_terms).  Each term is bounded through |q_hat . (v - off)|
    + |off * qsum| <= |q| (|v| + 2 offd), offd = |offset| sqrt(D), the
    offset of the codes' width `bits` (8 or 16)."""
    offd = abs(qz.affine_constants(bits)[1]) * float(dims) ** 0.5
    if metric == "euclidean":
        vmax = torch.where(valid, norms, torch.zeros_like(norms)).max()
        return qn2 + 4.0 * qn2.sqrt() * (vmax.sqrt() + 2.0 * offd) + vmax
    live = valid & (norms > 0.0)
    vmin = torch.where(live, norms, torch.full_like(norms, np.inf)).min()
    return torch.full_like(qn2, 1.25) + \
        2.0 * offd * torch.rsqrt(vmin.clamp_min(1e-30))


# segmin_i8_launch and surface_i8_launch: eight pointers (slices, qscale,
# codes, norms, valid, qn2, qsum, out), Q, N, D, Kp, bits, cosine, scale,
# offset, then seg (segmin) or out_bf16 (surface), vec, and the stream
_I8_ENTRY_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def _launch_i8(symbol: str, out, last: int, queries, codes, norms, valid,
               metric: str, bits: int):
    """Launch `symbol` of csrc/segmin_i8.cu (segmin_i8_launch with `last` =
    seg, surface_i8_launch with `last` = out_bf16) into `out` on 8-bit or
    (segmin_i8_launch) 16-bit codes -> slice_queries' dq_rel."""
    q, d = queries.shape
    if d > I8_MAX_DIMS:
        raise ValueError(f"D={d} exceeds the int8 route's {I8_MAX_DIMS} "
                         f"dims (int32 slice sums could overflow)")
    _, qn2, qsum, _, scale, offset = _kernel_operands(queries, codes, norms,
                                                      valid, bits)
    slices, qscale, dq_rel = slice_queries(queries)
    if bits == 16:
        slices = hilo_order(slices)
    n = codes.shape[0]
    # the kernel reads norms and validity in whole 32-row tiles, 16 bytes
    # at a time: pad rows are invalid (and never stored), starts aligned
    pad = -n % 32
    if pad:
        norms = torch.cat((norms, norms.new_zeros(pad)))
        valid = torch.cat((valid, valid.new_zeros(pad)))
    norms, valid = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (norms, valid))
    # code copy width: 16-byte cp.async where every row start allows it
    row_bytes = d * codes.element_size()
    ptr = codes.data_ptr()
    vec = next(v for v in (16, 4, 1) if row_bytes % v == 0 and ptr % v == 0)
    fn = cuda_build.entry("segmin_i8", symbol, _I8_ENTRY_ARGTYPES)
    rc = fn(slices.data_ptr(), qscale.data_ptr(), ptr, norms.data_ptr(),
            valid.data_ptr(), qn2.data_ptr(), qsum.data_ptr(), out.data_ptr(),
            q, n, d, slices.shape[2], bits, int(metric != "euclidean"),
            scale, offset, last, vec, cuda_build.launch_stream(codes.device))
    cuda_build.check(rc, symbol)
    return dq_rel


def _segmin_i8(queries, codes, norms, valid, *, bits: int, metric: str,
               seg: int):
    """K1 (seg 32) and K5/K6 (seg 16, 64, 128) on the int8 route, 8- or
    16-bit codes -> (segmins, dq_rel)."""
    global launches, i8_launches, free_seg_launches, i8_free_seg_launches
    global i8_hilo_launches
    out = torch.empty((queries.shape[0], codes.shape[0] // seg),
                      dtype=torch.float32, device=codes.device)
    dq_rel = _launch_i8("segmin_i8_launch", out, seg, queries, codes, norms,
                        valid, metric, bits)
    if bits == 16:
        i8_hilo_launches += 1
    if seg == DEFAULT_SEG:
        launches += 1
        i8_launches += 1
    else:
        free_seg_launches += 1
        i8_free_seg_launches += 1
    return out, dq_rel


def segmin_fp32(queries, codes, norms, valid, *, bits: int, metric: str,
                seg: int):
    """The fp32 segment-min kernel (csrc/segmin.cu) on CUDA tensors, at any
    width and at seg 16, 32, 64 or 128, on the query tile fp32_query_tile
    picks for Q."""
    global launches, free_seg_launches
    _check_kernel_seg(seg)
    out = torch.empty((queries.shape[0], codes.shape[0] // seg),
                      dtype=torch.float32, device=codes.device)
    _launch_fp32("segmin", out, seg, queries, codes, norms, valid, bits=bits,
                 metric=metric)
    if seg == DEFAULT_SEG:
        launches += 1
    else:
        free_seg_launches += 1
    return out


def _segment_min(queries, codes, norms, valid, *, bits: int, metric: str,
                 seg: int):
    """segment_min_scan -> (segmins, dq_rel): dq_rel is slice_queries'
    (Q,) query-slicing error where the int8 route ran, else None."""
    global pairs_scored
    _check_scan_args(queries, codes, norms, valid, bits, seg)
    route = _route(codes, bits, "segmin", queries.shape[0])
    pairs_scored += queries.shape[0] * codes.shape[0]
    if route == "plain":
        return segment_min_scan_plain(queries, codes, norms, valid, bits=bits,
                                      metric=metric, seg=seg), None
    _check_kernel_seg(seg)
    if route == "i8":
        return _segmin_i8(queries, codes, norms, valid, bits=bits,
                          metric=metric, seg=seg)
    return segmin_fp32(queries, codes, norms, valid, bits=bits,
                       metric=metric, seg=seg), None


def segment_min_scan(queries, codes, norms, valid, *, bits: int, metric: str,
                     seg: int = DEFAULT_SEG):
    """(Q, D) f32 queries x (N, W) codes -> (Q, N/seg) f32 segment minima of
    the surrogate distance, invalid rows +inf, in original segment order.

    CUDA tensors on the current device launch the kernel `_route` picks at
    seg 16, 32, 64 or 128 (K1 at 32, the K5/K6 port at the others): 8-bit
    codes, and 16-bit codes up to hilo_max_dims (but small batches on
    narrow rows), the int8 tensor-core route, whose error carries
    slice_queries' dq_rel; other widths and shapes the fp32 kernel.  CPU
    tensors take the plain version at any seg."""
    return _segment_min(queries, codes, norms, valid, bits=bits,
                        metric=metric, seg=seg)[0]


# ---------------------------------------------------------------------------
# K4: full surrogate surface
# ---------------------------------------------------------------------------

def _surface_i8(queries, codes, norms, valid, *, metric: str, exact: bool):
    """K4 on the int8 route -> (surface, dq_rel)."""
    global surface_launches, i8_surface_launches
    out = torch.empty((queries.shape[0], codes.shape[0]), device=codes.device,
                      dtype=torch.float32 if exact else torch.bfloat16)
    dq_rel = _launch_i8("surface_i8_launch", out, int(not exact), queries,
                        codes, norms, valid, metric, 8)
    surface_launches += 1
    i8_surface_launches += 1
    return out, dq_rel


def surface_fp32(queries, codes, norms, valid, *, bits: int, metric: str,
                 exact: bool):
    """K4's fp32 kernel (csrc/surface.cu) on CUDA tensors, at any width, on
    the query tile fp32_query_tile picks for Q: it rounds neither queries
    nor codes, so its f32 surface is within surface_delta of an exact
    evaluation."""
    global surface_launches
    out = torch.empty((queries.shape[0], codes.shape[0]), device=codes.device,
                      dtype=torch.float32 if exact else torch.bfloat16)
    _launch_fp32("surface", out, int(not exact), queries, codes, norms, valid,
                 bits=bits, metric=metric)
    surface_launches += 1
    return out


def _score_surface(queries, codes, norms, valid, *, bits: int, metric: str,
                   exact: bool = False):
    """score_surface -> (surface, dq_rel): dq_rel is slice_queries' (Q,)
    query-slicing error where the int8 route ran, else None."""
    global pairs_scored
    _check_scan_args(queries, codes, norms, valid, bits, 1)
    route = _route(codes, bits, "surface", queries.shape[0])
    pairs_scored += queries.shape[0] * codes.shape[0]
    if route == "plain":
        return score_surface_plain(queries, codes, norms, valid, bits=bits,
                                   metric=metric, exact=exact), None
    if route == "i8":
        return _surface_i8(queries, codes, norms, valid, metric=metric,
                           exact=exact)
    return surface_fp32(queries, codes, norms, valid, bits=bits,
                        metric=metric, exact=exact), None


def score_surface(queries, codes, norms, valid, *, bits: int, metric: str,
                  exact: bool = False):
    """(Q, D) f32 queries x (N, W) codes -> (Q, N) surrogate-distance
    surface, invalid rows +inf: f32 when `exact`, else bf16 rounded from
    the f32 value.

    CUDA tensors on the current device launch K4 by `_route`: 8-bit codes
    the int8 tensor-core route (within surface_delta with slice_queries'
    dq_rel of an exact evaluation), other widths the fp32 kernel (within
    surface_delta); CPU tensors take the plain version."""
    return _score_surface(queries, codes, norms, valid, bits=bits,
                          metric=metric, exact=exact)[0]


# ---------------------------------------------------------------------------
# Select and rerank
# ---------------------------------------------------------------------------

def dist_surr(qn2, dots, cnorms, cvalid, metric):
    """Metric epilogue of the rerank: (Q, C) dots and the queries' (Q, 1)
    squared norms -> (dist, surrogate), invalid rows +inf, zero vectors at
    the reference distance (cosine 1.0)."""
    if metric == "euclidean":
        surr = (qn2 - 2.0 * dots + cnorms).clamp_min(0.0)
        dist = surr.sqrt()
    else:
        qn = qn2.sqrt()
        vn = cnorms.sqrt()
        denom = qn * vn
        one = torch.ones_like(dots)
        cos = torch.where(denom > 0.0,
                          dots / torch.where(denom > 0.0, denom, one), one)
        cos = cos.clamp(-1.0, 1.0)
        dist = torch.acos(cos) / np.pi
        zero = (qn == 0.0) | (vn == 0.0)
        dist = torch.where(zero, one, dist)
        surr = torch.where(zero, one, (1.0 - cos) * 0.5)
    inf = torch.full_like(dist, np.inf)
    return torch.where(cvalid, dist, inf), torch.where(cvalid, surr, inf)


def _candidate_distances(queries, ccodes, cnorms, cvalid, bits, metric):
    """Exact distances and surrogates of gathered candidates (Q, C, W):
    full fp32 at every width — the candidate set is tiny next to the scan,
    and exact f32 here is what lets the flag prove the top-k."""
    global rerank_rows
    rerank_rows += ccodes.shape[0] * ccodes.shape[1]
    dots = dist_ops.candidate_dots(queries, ccodes, bits)
    return dist_surr(queries.square().sum(dim=-1, keepdim=True), dots,
                     cnorms, cvalid, metric)


def gather_segments(arr, seg_idx, seg: int):
    """Contiguous segment gather: (N, ...) x (Q, S) -> (Q, S*seg, ...)."""
    n = arr.shape[0]
    tail = tuple(arr.shape[1:])
    flat = arr.reshape(n // seg, -1)
    g = flat.index_select(0, seg_idx.reshape(-1))
    qn, s = seg_idx.shape
    return g.reshape((qn, s * seg) + tail)


def surface_accum_eps(dims: int) -> float:
    """f32 accumulation cushion, scaled with the feature dimension: the
    worst case of a D-term f32 dot is ~D*2^-24 relative, once for the
    surface and once for the rerank; the 2e-5 floor covers small D."""
    return 2e-5 + 2.0 * dims * 2.0 ** -24


def surface_delta(qn2, norms, valid, *, metric: str, dims: int,
                  dq_rel=None, bits=None):
    """Provable per-query bound (surrogate units) on the error of the
    surfaces of K1, K5/K6 and K4.

    The fp32 kernels round neither queries nor codes (codes are exact in
    f32 at every width), so their error is the f32 accumulation cushion
    alone: the JAX package's bound with no query-rounding (dq_rel) and no
    code-split (dc_rel) term, as its exact surface uses.  The int8 route
    takes exact integer products of the sliced query q_hat, so its bound is
    the reference's form (pallas_scan.surface_delta) with slice_queries'
    (Q,) `dq_rel` and dc_rel = 0 (8-bit codes are exact in int8, 16-bit
    codes in their high and low bytes): the
    query-rounding term couples to v - offset*1 through the unrounded qsum,
    |err| <= dq_rel ||q|| (||v|| + |offset| sqrt(D)), plus the cushion.
    `bits` (the codes' width, for the offset) goes with `dq_rel`."""
    eps = surface_accum_eps(dims)
    if dq_rel is None:
        if metric == "euclidean":
            vmax = torch.where(valid, norms, torch.zeros_like(norms)).max()
            return eps * (qn2 + vmax)
        return torch.full_like(qn2, eps)
    if bits is None:
        raise ValueError("surface_delta: dq_rel needs the codes' bits")
    off = abs(qz.affine_constants(bits)[1]) if bits in (4, 8, 16) else 0.0
    offd = off * float(dims) ** 0.5
    if metric == "euclidean":
        vmax = torch.where(valid, norms, torch.zeros_like(norms)).max()
        return 2.0 * dq_rel * qn2.sqrt() * (vmax.sqrt() + offd) + \
            eps * (qn2 + vmax)
    live = valid & (norms > 0.0)
    vmin = torch.where(live, norms, torch.full_like(norms, np.inf)).min()
    return 0.5 * dq_rel * (1.0 + offd * torch.rsqrt(vmin.clamp_min(1e-30))) \
        + eps


def _select_and_rerank(queries, segmins, codes, norms, valid, delta, *,
                       bits: int, metric: str, k: int, seg: int, s: int,
                       with_ties: bool):
    """Stage 2 for one chunk of queries (select_segments with the gathered
    codes' fp32 rerank)."""
    def rerank(seg_idx):
        return _candidate_distances(
            queries, gather_segments(codes, seg_idx, seg),
            gather_segments(norms, seg_idx, seg),
            gather_segments(valid, seg_idx, seg), bits, metric)

    return select_segments(segmins, delta, rerank,
                           qn2=queries.square().sum(dim=-1), metric=metric,
                           k=k, seg=seg, s=s, with_ties=with_ties)


def select_segments(segmins, delta, rerank, *, qn2, metric: str, k: int,
                    seg: int, s: int, with_ties: bool):
    """Top segments -> rerank -> top-k ordered by (distance, row), plus the
    provable-completeness flag.  `rerank(seg_idx)` returns the exact
    (dist, surrogate) of the rows of the (Q, SV) selected segments, (Q,
    SV * seg) each; qn2 (Q,) the queries' squared norms.

    The flag (with_ties): kth_exact = k-th smallest EXACT segment minimum
    among the S selected; the global k-th best row is <= kth_exact, so any
    true top-k row w has surr(w) <= kth_exact and its segment's surface
    min <= kth_exact + delta.  If the (S+1)-th surface segment's exact min
    m_next satisfies m_next - delta > kth_exact + 1.1*delta, every segment
    that could hold a winner was selected.  K1's minima are f32 (no
    storage rounding), so the reference's bf16 half-ulp factors are 0.
    m_next = +inf proves it too: a segment with a valid row has a finite
    surface minimum, so that segment and every later one hold no valid
    row (a filter, or a mesh shard, with few valid rows left; the
    reference's flag is 0 there and its ladder climbs to every segment)."""
    nq, nseg = segmins.shape
    dev = segmins.device
    full = s >= nseg  # every segment gathered: complete by construction
    sv = s if (full or not with_ties) else s + 1
    if full:
        seg_idx = torch.arange(nseg, device=dev).expand(nq, nseg)
    else:
        seg_idx = torch.topk(segmins, sv, dim=1, largest=False,
                             sorted=True).indices              # (Qc, SV)
    rows = (seg_idx[:, :, None] * seg +
            torch.arange(seg, device=dev)[None, None, :]
            ).reshape(nq, sv * seg)
    dist, surr = rerank(seg_idx)
    kk = min(k, dist.shape[1])
    d_out, r_out = dist_ops.sort_topk(dist, rows, kk)
    if not with_ties:
        return d_out, r_out
    if full:
        return d_out, r_out, torch.ones((nq,), dtype=torch.int32,
                                        device=dev)
    segsurr = surr.reshape(nq, sv, seg).amin(dim=-1)          # (Qc, SV)
    kth_exact = torch.topk(segsurr[:, :s], min(k, s), dim=1, largest=False,
                           sorted=True).values[:, -1]
    m_next = segsurr[:, s]
    ok = (((m_next - delta) > (kth_exact + 1.1 * delta)) |
          torch.isinf(m_next)).to(torch.int32)
    if metric != "euclidean":
        # a zero cosine query scores every row at exactly 1.0: any k rows
        # are the true top-k
        ok = torch.where(qn2 > 0.0, ok, torch.ones_like(ok))
    return d_out, r_out, ok


def fused_scan_topk(queries, codes, norms, valid, *, bits: int, metric: str,
                    k: int, seg: int = DEFAULT_SEG, tie_margin=None,
                    with_ties: bool = False,
                    gather_bytes: int = GATHER_BUDGET_BYTES):
    """Exhaustive fused scan -> (dist (Q, k) ascending, rows (Q, k)
    [, ok (Q,) int32 with_ties]).

    N (rows of codes) must be a multiple of seg; padding rows carry
    valid=False.  (k, Q) must satisfy fused_k_ok.  Distances tied in value
    come back ordered by row.  The query batch is reranked in chunks whose
    gathered candidates stay within `gather_bytes` of f32."""
    q0, d = queries.shape
    if not fused_k_ok(k, q0):
        raise ValueError(f"k={k} with {q0} queries exceeds the fused scan")
    queries = queries.to(torch.float32)
    segmins, dq_rel = _segment_min(queries, codes, norms, valid, bits=bits,
                                   metric=metric, seg=seg)
    if tie_margin is None:
        tie_margin = DEFAULT_TIE_MARGIN
    nseg = norms.shape[0] // seg
    s = min(k + tie_margin, nseg)
    full = s >= nseg
    sv = s if (full or not with_ties) else s + 1
    delta = None
    if with_ties and not full:
        # the int8 route's surface carries its query-slicing error
        delta = surface_delta(queries.square().sum(dim=-1), norms, valid,
                              metric=metric, dims=d, dq_rel=dq_rel, bits=bits)
    chunk = max(1, gather_bytes // (4 * sv * seg * max(d, 1)))
    parts = [_select_and_rerank(
        queries[a:a + chunk], segmins[a:a + chunk], codes, norms, valid,
        None if delta is None else delta[a:a + chunk], bits=bits,
        metric=metric, k=k, seg=seg, s=s, with_ties=with_ties)
        for a in range(0, q0, chunk)]
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


# ---------------------------------------------------------------------------
# Non-fused selection over K4's surface
# ---------------------------------------------------------------------------

# device working set of one surface_topk query chunk: a quarter for the
# candidates' gather and rerank pieces, the rest for the selection
SURFACE_BUDGET_BYTES = 4 << 30


# torch.topk on CUDA sorts whole rows (values and int64 indices, 24 more
# bytes a row) when it is given this many rows or fewer, each of 100k
# entries or more; past it, its radix select keeps no copy of the input
TOPK_SORT_SLICES = 10


def surface_query_bytes(n_rows: int, n_cand: int, sorts: bool = True) -> int:
    """Selection bytes one query adds to a surface_topk chunk: its (N,) f32
    surface row (and, when torch.topk sorts, 24 bytes a row more), plus its
    n_cand selected candidates (topk's values and indices, the reranked
    distance and surrogate, sort_topk's argsorts and gathers: 64 bytes
    each).  The candidates' codes are gathered and reranked in pieces
    outside this (rerank_piece)."""
    return (28 if sorts else 4) * n_rows + 64 * n_cand


def surface_chunk(n_queries: int, n_rows: int, n_cand: int,
                  budget_bytes: int = SURFACE_BUDGET_BYTES) -> int:
    """Queries per surface_topk chunk: as many as the selection's share of
    the budget holds (at least one), rounded down to whole 128-query
    kernel tiles above one tile."""
    share = budget_bytes - budget_bytes // 4
    chunk = min(n_queries, max(1, share // surface_query_bytes(
        n_rows, n_cand, sorts=False)))
    if chunk <= TOPK_SORT_SLICES:
        chunk = min(chunk, max(1, share // surface_query_bytes(n_rows,
                                                               n_cand)))
    elif chunk > 128:
        chunk -= chunk % 128
    return chunk


def rerank_piece(n_queries: int, dims: int,
                 budget_bytes: int = SURFACE_BUDGET_BYTES) -> int:
    """Candidates per query in one gather-and-rerank piece: codes of up to
    4 bytes a value decoded to f32, with the 4-bit nibble planes'
    intermediates (12 bytes a dim), and 32 bytes of rows, norms, validity,
    dots and distances, within a quarter of the budget."""
    return max(1, (budget_bytes // 4) // (n_queries * (12 * dims + 32)))


def _rerank_rows(queries, cand, codes, norms, valid, *, bits: int,
                 metric: str, piece: int):
    """(dist, surrogate) of each query's candidate rows (Q, C) by the fused
    rerank's formula, gathered and reranked `piece` candidates at a
    time."""
    nq, c = cand.shape
    dist = torch.empty((nq, c), dtype=torch.float32, device=codes.device)
    surr = torch.empty_like(dist)
    for a in range(0, c, piece):
        idx = cand[:, a:a + piece]
        flat = idx.reshape(-1)
        ccodes = codes.index_select(0, flat).reshape(
            tuple(idx.shape) + tuple(codes.shape[1:]))
        dist[:, a:a + piece], surr[:, a:a + piece] = _candidate_distances(
            queries, ccodes, norms.index_select(0, flat).reshape(idx.shape),
            valid.index_select(0, flat).reshape(idx.shape), bits, metric)
    return dist, surr


def surface_topk(queries, codes, norms, valid, *, bits: int, metric: str,
                 k: int, margin: int,
                 budget_bytes: int = SURFACE_BUDGET_BYTES):
    """Exhaustive top-k at any (k, Q) -> (dist (Q, kk) ascending, rows
    (Q, kk), ok (Q,) int32), kk = min(k, N), ties ordered by row.

    Per query chunk (surface_chunk), the S = kk + margin smallest entries
    of K4's f32 surface are selected with torch.topk, their distances
    recomputed by the fused rerank's own formula (_candidate_distances) and
    the kk best kept, so a row's distance is the same whichever route found
    it.  The flag proves the cut as the fused scan's does: every true
    top-kk row w has surface(w) <= kth_exact + delta (kth_exact = the kk-th
    smallest reranked surrogate among the S), and every row left out has a
    surface value no smaller than the largest selected one, s_max; so
    s_max > kth_exact + 1.1*delta (or s_max = +inf: only invalid rows were
    left out) means none was missed; delta is surface_delta with the dq_rel
    of the route that computed the surface (_score_surface).  S >= N
    selects every row (complete by construction).  Where ok == 0 the caller re-dispatches with a wider
    margin.  Invalid rows come back at +inf when fewer than kk rows are
    valid."""
    q0, d = queries.shape
    n = codes.shape[0]
    kk = min(k, n)
    s = min(kk + max(margin, 0), n)
    queries = queries.to(torch.float32)
    qn2 = queries.square().sum(dim=-1)
    chunk = surface_chunk(q0, n, s, budget_bytes)
    piece = rerank_piece(chunk, d, budget_bytes)
    parts = []
    for a in range(0, q0, chunk):
        qc = queries[a:a + chunk]
        nq = qc.shape[0]
        if s >= n:
            cand = torch.arange(n, device=codes.device).expand(nq, n)
        else:
            surf, dq_rel = _score_surface(qc, codes, norms, valid, bits=bits,
                                          metric=metric, exact=True)
            # the int8 route's surface carries its query-slicing error
            delta = surface_delta(qn2[a:a + chunk], norms, valid,
                                  metric=metric, dims=d, dq_rel=dq_rel,
                                  bits=bits)
            top = torch.topk(surf, s, dim=1, largest=False, sorted=False)
            del surf
            cand = top.indices
            s_max = top.values.amax(dim=1)
            del top
        dist, surr = _rerank_rows(qc, cand, codes, norms, valid, bits=bits,
                                  metric=metric, piece=piece)
        if s >= n:
            ok = torch.ones((nq,), dtype=torch.int32, device=codes.device)
        else:
            kth_exact = torch.kthvalue(surr, kk, dim=1).values
            ok = (s_max > kth_exact + 1.1 * delta) | torch.isinf(s_max)
            if metric != "euclidean":
                # a zero cosine query scores every row at exactly 1.0: any
                # kk rows are the true top-kk
                ok = ok | (qn2[a:a + chunk] == 0.0)
            ok = ok.to(torch.int32)
        del surr
        parts.append(dist_ops.sort_topk(dist, cand, kk) + (ok,))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))

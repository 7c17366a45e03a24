"""The int8 tensor-core route (syzgydb_tpu_torch/csrc/segmin_i8.cu: K1,
K5/K6 and K4 on 8-bit codes, K1 and K5/K6 on 16-bit codes) on the CPU: the
query slicing it runs on (ops/scan.py::slice_queries), a plain emulation of
the kernel's integer arithmetic against the JAX package's segment-min and
surface references, the 16-bit codes' high/low byte split and the operand
order the kernel's fragments give it, and the flags' bound with the slicing
error (fused_scan_topk and surface_topk).

The kernel itself runs only on the card (tests/test_torch_cuda.py).  Here
its arithmetic is emulated exactly as it is done there: int64 products of
the int8 slices with the codes (at 16 bits with each code's signed high
byte and unsigned low byte), the exact combine A_0 2^14 + A_1 2^7 + A_2
(A_s = 256 H_s + L_s at 16 bits), one rounding to f32, and the f32
surrogate epilogue with the unrounded query's |q|^2 and sum.  Tolerances:
the emulation and the JAX references
each lie within their own surface bound of the exact surface, so the two
may differ by the sum of the bounds (the port's surface_delta with the
slicing error dq_rel, and the reference's with its bf16 query rounding or
none for its exact surface); against an exact evaluation of the same
formula on q_hat the emulation lies within 4 f32 ulps of the surrogate's
terms (i8_term_scale)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syzgydb_tpu.ops import pallas_scan as jscan
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import quantize as tqz
from syzgydb_tpu_torch.ops import scan as tscan

SEG = tscan.DEFAULT_SEG
METRICS = ["euclidean", "cosine"]
BITS = [8, 16]  # the widths the int8 route takes
ULP = 2.0 ** -24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def superseded():
    """tools_dev/superseded_kernels.py (K5/K6's reference), loaded by path."""
    path = os.path.join(ROOT, "tools_dev", "superseded_kernels.py")
    spec = importlib.util.spec_from_file_location("superseded_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _queries(q, d, seed, magnitude=1.0):
    rng = np.random.default_rng(seed)
    qs = np.float32(rng.standard_normal((q, d)) * magnitude)
    qs[0] = 0.0
    return qs


@pytest.mark.parametrize("magnitude", [1.0, 1e-30, 1e30])
@pytest.mark.parametrize("d", [33, 383, 384])
def test_slices_in_range_and_q_hat_exact(d, magnitude):
    q = _queries(6, d, seed=d, magnitude=magnitude)
    slices, scale, dq = tscan.slice_queries(torch.from_numpy(q))
    kp = -(-d // 32) * 32
    assert slices.dtype == torch.int8 and slices.shape == (3, 6, kp)
    assert scale.dtype == dq.dtype == torch.float32
    a = slices.numpy().astype(np.int64)
    assert np.abs(a[0]).max() <= 127
    assert np.abs(a[1:]).max() <= 64
    assert (a[:, :, d:] == 0).all()  # the pad dims are zero
    # the scale is a power of two, finite for the zero query too
    sc = scale.numpy().astype(np.float64)
    assert np.isfinite(sc).all()
    assert (np.frexp(sc)[0] == 0.5).all()
    # q_hat = scale * sum_s a_s 2^-7s is exact in f32
    qhat = sc[:, None] * (a[0] + a[1] / 128.0 + a[2] / 16384.0)[:, :d]
    assert (qhat.astype(np.float32).astype(np.float64) == qhat).all()
    np.testing.assert_array_equal(
        tscan.unslice_queries(slices, scale).numpy()[:, :d], qhat)
    # dq_rel: the f64 evaluation, rounded up to f32; 0 for the zero query
    q64 = q.astype(np.float64)
    num = np.linalg.norm(q64 - qhat, axis=1)
    den = np.linalg.norm(q64, axis=1)
    want = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    got = dq.numpy().astype(np.float64)
    assert got[0] == 0.0
    assert (got >= want).all()
    assert (got - want <= np.spacing(np.float32(want)) + 1e-300).all()
    # ~22 bits: dq_rel near 1e-6
    assert got[1:].max() < 4e-6


def test_half_unit_remainder_stays_in_int8():
    """A remainder of exactly half a unit: scaled by 2^8 a residual slice
    would be +128; by 2^7 it is 64."""
    q = np.float32([[100.0, 50.5, -0.5, 31.75, 127.0, -127.0],
                    [127.5, 50.5, 0.25, -0.5, 1.0, 0.0]])
    slices, scale, dq = tscan.slice_queries(torch.from_numpy(q))
    a = slices.numpy().astype(np.int64)
    assert np.abs(a[0]).max() <= 127 and np.abs(a[1:]).max() <= 64
    assert a[1, 0, 1] == 64  # 50.5 -> 50 (half to even) + 64 / 128
    qhat = tscan.unslice_queries(slices, scale).numpy()[:, :6]
    np.testing.assert_array_equal(qhat, q.astype(np.float64))
    assert dq.tolist() == [0.0, 0.0]


def _corpus(n=4096, d=48, q=5, seed=0, bits=8):
    """8- or 16-bit codes with zero rows, invalid rows and a wholly invalid
    segment; a zero query rides along."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, size=(n, d))
    db[7] = 0.0
    db[100:103] = 0.0
    _, codes, norms = tdist.ingest_reprs(db, bits)
    valid = np.ones(n, dtype=bool)
    valid[SEG * 3:SEG * 4] = False
    valid[rng.choice(n, 40, replace=False)] = False
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    queries[-1] = 0.0
    return queries, codes, norms, valid


def _split16(c):
    """int16 codes (as int64) -> (signed high byte in [-128, 127], unsigned
    low byte in [0, 255]), c = 256 hi + lo."""
    return c >> 8, c & 0xFF


def _combine(slices, codes, bits):
    """The kernel's exact integer combine of (S, Q, K) slices with (N, K)
    codes: v = A_0 2^14 + A_1 2^7 + A_2 in int64, A_s slice s's dot with
    the codes (at 16 bits 256 H_s + L_s, H_s and L_s its int32 sums with
    the high and low bytes).  -> (v, the int32 sums)."""
    a = slices.to(torch.int64)
    c = codes.to(torch.int64)
    if bits == 8:
        sums = [a[i] @ c.T for i in range(3)]
        parts = sums
    else:
        hi, lo = _split16(c)
        sums = [a[i] @ x.T for i in range(3) for x in (hi, lo)]
        parts = [256 * sums[2 * i] + sums[2 * i + 1] for i in range(3)]
    return parts[0] * 16384 + parts[1] * 128 + parts[2], sums


def _emulate_i8_surface(queries, codes, norms, valid, metric, bits=8):
    """The int8 route's arithmetic in plain PyTorch, as the full (Q, N) f32
    surface (K4 writes it at 8 bits; K1 and K5/K6 fold it): int64 products
    of the slices with the codes, the exact combine, one rounding to f32,
    the f32 epilogue with the f32 affine constants the kernel is passed."""
    tq = torch.from_numpy(queries)
    d = queries.shape[1]
    slices, scale, _ = tscan.slice_queries(tq)
    v, _ = _combine(slices[:, :, :d], torch.from_numpy(codes), bits)
    # exact in f64 (|v| < 2^45 at 8 bits, 2^52 at 16), rounded once
    raw = (v.double() * (scale.double() * 2.0 ** -14)[:, None]).float()
    aff_s, aff_o = (torch.tensor(x, dtype=torch.float32)
                    for x in tqz.affine_constants(bits))
    qn2 = tq.square().sum(-1, keepdim=True)
    dots = aff_s * raw + aff_o * tq.sum(-1, keepdim=True)
    nv = torch.from_numpy(norms)[None, :]
    if metric == "euclidean":
        s = (qn2 - 2.0 * dots + nv).clamp_min(0.0)
    else:
        den = qn2 * nv
        inv = torch.rsqrt(torch.where(den > 0, den, torch.ones_like(den)))
        cos = torch.where(den > 0, dots * inv, torch.full_like(dots, -1.0))
        s = (1.0 - cos.clamp(-1.0, 1.0)) * 0.5
    return torch.where(torch.from_numpy(valid)[None, :], s,
                       torch.full_like(s, np.inf))


def _emulate_i8(queries, codes, norms, valid, metric, seg=SEG, bits=8):
    """The int8 route's segment minima (K1 at seg 32, K5/K6 at 16/64/128),
    folded from the emulated surface."""
    s = _emulate_i8_surface(queries, codes, norms, valid, metric, bits)
    return s.reshape(len(queries), -1, seg).amin(-1).numpy()


def _port_delta(queries, norms, valid, metric, bits=8):
    tq, tn, tv = (torch.from_numpy(a) for a in (queries, norms, valid))
    dq = tscan.slice_queries(tq)[2]
    return tscan.surface_delta(tq.square().sum(-1), tn, tv, metric=metric,
                               dims=queries.shape[1], dq_rel=dq,
                               bits=bits).numpy()[:, None]


def _jax_delta(queries, norms, valid, metric, bf16: bool, bits=8):
    """The JAX package's bound on its own surface: bf16 query rounding
    (its kernel outside exact mode) or none (its exact surface)."""
    q = torch.from_numpy(queries)
    qn2 = q.square().sum(-1)
    if bf16:
        dqa = (q - q.to(torch.bfloat16).float()).square().sum(-1).sqrt()
        dq = torch.where(qn2 > 0, dqa * torch.rsqrt(qn2.clamp_min(1e-30)),
                         torch.ones_like(qn2))
    else:
        dq = torch.zeros_like(qn2)
    d = queries.shape[1]
    return np.asarray(jscan.surface_delta(
        jnp.asarray(dq.numpy()), jnp.asarray(qn2.numpy()), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, dims=d,
        eps=jscan.surface_accum_eps(d)))[:, None]


def _assert_within(got, want, tol):
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64))
    assert (err <= np.broadcast_to(tol, got.shape)[fin]).all(), \
        float(err.max())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("metric", METRICS)
def test_emulation_matches_jax_ilv_kernel(metric, bits):
    """The JAX kernel rounds queries to bf16 (and at 16 bits multiplies
    them with the codes' exact high/low byte split in f32)."""
    queries, codes, norms, valid = _corpus(seed=5, bits=bits)
    got = _emulate_i8(queries, codes, norms, valid, metric, bits=bits)
    assert np.isinf(got[:, 3]).all()  # the wholly invalid segment
    ref = np.asarray(jscan.segment_min_scan_ilv(
        jnp.asarray(queries), jnp.asarray(jscan.make_ilv_codes(codes)),
        jnp.asarray(norms), jnp.asarray(valid), bits=bits, metric=metric,
        interpret=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric, bits) +
                   _jax_delta(queries, norms, valid, metric, bf16=True,
                              bits=bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
def test_emulation_matches_jax_exact_surface(metric, d, bits):
    queries, codes, norms, valid = _corpus(d=d, seed=6, bits=bits)
    got = _emulate_i8(queries, codes, norms, valid, metric, bits=bits)
    ref = np.asarray(jscan.segment_min_scan_xla(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, exact=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric, bits) +
                   _jax_delta(queries, norms, valid, metric, bf16=False,
                              bits=bits))


def _tight_and_bounded(got, queries, codes, norms, valid, metric, bits):
    """The emulated minima (seg 32) within 4 f32 ulps of the surrogate's
    terms (i8_term_scale) of an f64 evaluation on q_hat with the unrounded
    query's |q|^2 and sum, and within the flag's bound (surface_delta with
    dq_rel) of the exact surface on the unrounded queries; identical +inf
    positions both ways."""
    d = queries.shape[1]
    tq, tc, tn, tv = (torch.from_numpy(a) for a in
                      (queries, codes, norms, valid))
    slices, scale, _ = tscan.slice_queries(tq)
    qhat = tscan.unslice_queries(slices, scale)[:, :d]
    qn2 = tq.square().sum(-1)
    want = tscan.segment_min_scan_plain(
        qhat, tc, tn, tv, bits=bits, metric=metric, dtype=torch.float64,
        query_terms=(qn2, tq.sum(-1))).numpy()
    tol = 4 * ULP * tscan.i8_term_scale(qn2, tn, tv, metric=metric, dims=d,
                                        bits=bits).double().numpy()[:, None]
    _assert_within(got, want, tol)
    exact = tscan.segment_min_scan_plain(tq, tc, tn, tv, bits=bits,
                                         metric=metric,
                                         dtype=torch.float64).numpy()
    _assert_within(got, exact,
                   _port_delta(queries, norms, valid, metric, bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d", [48, 33, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_emulation_within_ulps_of_exact_on_q_hat(metric, d, bits):
    """The tight check the card holds the kernel to: an f64 evaluation on
    q_hat with the unrounded query's |q|^2 and sum, 4 f32 ulps of the
    surrogate's terms, identical +inf positions."""
    queries, codes, norms, valid = _corpus(n=2048, d=d, seed=7, bits=bits)
    got = _emulate_i8(queries, codes, norms, valid, metric, bits=bits)
    _tight_and_bounded(got, queries, codes, norms, valid, metric, bits)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d", [33, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_surface_delta_with_dq_rel_matches_jax(metric, d, bits):
    queries, _, norms, valid = _corpus(n=1024, d=d, seed=8, bits=bits)
    tq, tn, tv = (torch.from_numpy(a) for a in (queries, norms, valid))
    dq = tscan.slice_queries(tq)[2]
    qn2 = tq.square().sum(-1)
    port = tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d,
                               dq_rel=dq, bits=bits).numpy()
    ref = np.asarray(jscan.surface_delta(
        jnp.asarray(dq.numpy()), jnp.asarray(qn2.numpy()), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, dims=d,
        eps=jscan.surface_accum_eps(d)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    # without dq_rel: the f32 cushion alone, as before
    base = tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d).numpy()
    assert (port >= base).all()
    np.testing.assert_array_equal(
        tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d,
                            dq_rel=torch.zeros_like(dq), bits=bits).numpy(),
        base)


def test_hilo_split_is_exact_for_every_int16():
    """Every int16 code c is 256 hi + lo with hi = c >> 8 in [-128, 127]
    (int8) and lo = c & 0xFF in [0, 255] (uint8); and they are the odd and
    even bytes of the little-endian int16 in memory, the bytes the kernel's
    byte permutes pick (selectors 0x7531 and 0x6420)."""
    c = np.arange(-32768, 32768, dtype=np.int64)
    hi, lo = _split16(torch.from_numpy(c))
    hi, lo = hi.numpy(), lo.numpy()
    assert hi.min() == -128 and hi.max() == 127
    assert lo.min() == 0 and lo.max() == 255
    np.testing.assert_array_equal(256 * hi + lo, c)
    raw = c.astype(np.int16).view(np.uint8)
    np.testing.assert_array_equal(raw[1::2].view(np.int8), hi)
    np.testing.assert_array_equal(raw[0::2], lo)


def _worst_codes(kp):
    """int16 rows at the extremes of the split: every code -32768 (hi
    -128, lo 0), every code 32767 (127, 255), lo = 255 with hi -128, 0
    and -1, and alternating extremes."""
    rows = [np.full(kp, -32768), np.full(kp, 32767), np.full(kp, -32513),
            np.full(kp, 255), np.full(kp, -1),
            np.where(np.arange(kp) % 2, 32767, -32768)]
    return torch.from_numpy(np.stack(rows).astype(np.int16))


# Kp = 65,536: the widest 16-bit row csrc/segmin_i8.cu's bad_shape admits
@pytest.mark.parametrize("kp", [960, 1 << 16])
def test_hilo_combine_exact_on_worst_case_codes(kp):
    """The 16-bit combine sum_s 2^(14 - 7s) (256 H_s + L_s) equals
    q_hat . c / (scale 2^-14) exactly, up to the int32 limit of Kp: every
    slice's high and low sums fit int32 at the extreme slices (|a_0| =
    127, |a_1| = |a_2| = 64, signs alike and mixed), and f64 holds both
    sides exactly (|v| < 2^52)."""
    codes = _worst_codes(kp)
    q_sl = [np.stack([np.full(kp, 127), np.full(kp, 64), np.full(kp, 64)]),
            np.stack([np.full(kp, -127), np.full(kp, 64), np.full(kp, -64)]),
            np.stack([np.where(np.arange(kp) % 2, 127, -127),
                      np.full(kp, -64), np.full(kp, 64)])]
    slices = torch.from_numpy(np.stack(q_sl, axis=1).astype(np.int8))
    v, sums = _combine(slices, codes, 16)
    for x in sums:
        assert x.abs().max() < 2 ** 31
    assert max(int(x.abs().max()) for x in sums[1::2]) == 255 * 127 * kp
    assert v.abs().max() < 2 ** 52
    scale = torch.ones(3)
    qhat = tscan.unslice_queries(slices, scale)
    dots = qhat @ codes.to(torch.float64).T
    assert torch.equal(v.double() * 2.0 ** -14, dots)
    assert torch.equal(v, (dots * 2.0 ** 14).to(torch.int64))


@pytest.mark.parametrize("metric", METRICS)
def test_hilo_surface_within_bounds_on_worst_case_codes(metric):
    """surface_delta(bits=16) and i8_term_scale(bits=16) hold the emulated
    16-bit route against the exact evaluations on rows at the extremes of
    the split, at the cell's width (D = 960)."""
    d = 960
    rng = np.random.default_rng(21)
    codes = np.concatenate([
        _worst_codes(d).numpy(),
        rng.integers(-32768, 32768, size=(26, d)).astype(np.int16)])
    scale, offset = tqz.affine_constants(16)
    vals = codes.astype(np.float64) * scale + offset
    norms = np.float32((vals ** 2).sum(1))
    valid = np.ones(len(codes), dtype=bool)
    queries = np.float32(rng.uniform(-1, 1, size=(6, d)))
    queries[0] = 0.0
    got = _emulate_i8(queries, codes, norms, valid, metric, bits=16)
    _tight_and_bounded(got, queries, codes, norms, valid, metric, 16)


def _ldmatrix_x4(smem, addrs):
    """ldmatrix.sync.aligned.m8n8.x4.b16 on a byte array: lane l gives the
    16-byte row address of row l % 8 of matrix l // 8; lane t gets, of
    each matrix i, bytes 4 (t % 4) .. + 3 of its row t // 4, as one word
    (little-endian)."""
    rows = [smem[a:a + 16] for a in addrs]
    out = np.zeros((32, 4), dtype=np.uint32)
    for t in range(32):
        for i in range(4):
            b = rows[i * 8 + t // 4][4 * (t % 4):4 * (t % 4) + 4]
            out[t, i] = int.from_bytes(bytes(b), "little")
    return out


def _byte_perm(x, y, sel):
    b = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return bytes(b[(sel >> (4 * i)) & 0xF] for i in range(4))


def test_hilo_fragments_multiply_in_hilo_order():
    """One k32 step of the 16-bit kernel, lane by lane: the code tile's
    ldmatrix.x4 and byte permutes (csrc/segmin_i8.cu products<16>) give
    each thread the B fragment bytes that mma.m16n8k32 multiplies with the
    A fragment of the slices in hilo_order; the MMA's sums are each
    slice's exact dots with the codes' high and low bytes."""
    rng = np.random.default_rng(3)
    pitch = 144
    codes = rng.integers(-32768, 32768, size=(8, 32)).astype(np.int16)
    smem = np.zeros(8 * pitch, dtype=np.uint8)
    for r in range(8):
        smem[r * pitch:r * pitch + 64] = codes[r].view(np.uint8)
    # B (k32 x n8): b0 holds k = 4 tig .. + 3, b1 k = 16 + 4 tig .., n = g
    regs = _ldmatrix_x4(smem, [(l & 7) * pitch + (l >> 3) * 16
                               for l in range(32)])
    b_hi = np.zeros((32, 8), dtype=np.int64)
    b_lo = np.zeros((32, 8), dtype=np.int64)
    for t in range(32):
        g, tig = t // 4, t % 4
        r = regs[t]
        for k0, (x, y) in ((0, (r[0], r[1])), (16, (r[2], r[3]))):
            hi = np.frombuffer(_byte_perm(x, y, 0x7531), dtype=np.int8)
            lo = np.frombuffer(_byte_perm(x, y, 0x6420), dtype=np.uint8)
            b_hi[k0 + 4 * tig:k0 + 4 * tig + 4, g] = hi
            b_lo[k0 + 4 * tig:k0 + 4 * tig + 4, g] = lo
    # A (m16 x k32) of one slice in hilo order, as products' ldmatrix
    # reads it: a0/a2 rows g, a1/a3 rows g + 8, k as B's
    sl = rng.integers(-127, 128, size=(1, 16, 32)).astype(np.int8)
    ordered = tscan.hilo_order(torch.from_numpy(sl)).numpy()[0]
    amem = ordered.view(np.uint8).reshape(-1)
    aregs = _ldmatrix_x4(amem, [((l & 7) + ((l >> 3) & 1) * 8) * 32 +
                                (l >> 4) * 16 for l in range(32)])
    a = np.zeros((16, 32), dtype=np.int64)
    for t in range(32):
        g, tig = t // 4, t % 4
        for i, (row, k0) in enumerate(((g, 0), (g + 8, 0), (g, 16),
                                       (g + 8, 16))):
            w = int(aregs[t, i]).to_bytes(4, "little")
            a[row, k0 + 4 * tig:k0 + 4 * tig + 4] = np.frombuffer(
                w, dtype=np.int8)
    hi, lo = _split16(torch.from_numpy(codes.astype(np.int64)))
    s64 = sl[0].astype(np.int64)
    np.testing.assert_array_equal(a @ b_hi, s64 @ hi.numpy().T)
    np.testing.assert_array_equal(a @ b_lo, s64 @ lo.numpy().T)
    np.testing.assert_array_equal(256 * (a @ b_hi) + a @ b_lo,
                                  s64 @ codes.astype(np.int64).T)


def test_surface_delta_needs_bits_with_dq_rel():
    q = torch.ones(2)
    with pytest.raises(ValueError, match="bits"):
        tscan.surface_delta(q, q, torch.ones(2, dtype=torch.bool),
                            metric="cosine", dims=4, dq_rel=q)


@pytest.mark.parametrize("bits", BITS)
def test_cpu_route_carries_no_slicing_error(bits):
    """On the CPU the plain version runs on the unrounded queries: no
    dq_rel, so the flag's bound (and the fused scan's results) stay as
    they were."""
    queries, codes, norms, valid = _corpus(n=1024, q=3, seed=9, bits=bits)
    args = [torch.from_numpy(a) for a in (queries, codes, norms, valid)]
    out, dq = tscan._segment_min(*args, bits=bits, metric="cosine",
                                 seg=SEG)
    assert dq is None
    np.testing.assert_array_equal(
        out.numpy(), tscan.segment_min_scan_plain(
            *args, bits=bits, metric="cosine").numpy())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seg", [16, 64, 128])
@pytest.mark.parametrize("kernel", ["segment_min_scan",
                                    "segment_min_scan_nat"])
def test_emulation_matches_superseded_free_seg_kernels(superseded, kernel,
                                                       seg, metric, d, bits):
    """K5/K6 on the int8 route: the emulation's minima at seg 16/64/128
    against the archived TPU kernels in interpret mode (which round
    queries to bf16 for 8-bit codes and take f32 dots of 16-bit ones),
    within the sum of the two bounds."""
    queries, codes, norms, valid = _corpus(d=d, q=8, seed=seg + d,
                                           bits=bits)
    valid[128 * 5:128 * 6] = False  # a wholly invalid segment at every seg
    got = _emulate_i8(queries, codes, norms, valid, metric, seg=seg,
                      bits=bits)
    assert got.shape == (8, 4096 // seg)
    assert np.isinf(got[:, 128 * 5 // seg:128 * 6 // seg]).all()
    ref = np.asarray(getattr(superseded, kernel)(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, block_n=1024, seg=seg,
        interpret=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric, bits) +
                   _jax_delta(queries, norms, valid, metric,
                              bf16=bits == 8, bits=bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
def test_emulated_surface_matches_jax_surface_kernel(metric, d, bits):
    """K4 on the int8 route (8 bits), and at 16 bits the surface whose
    segment minima K1 and K5/K6 take: the emulated f32 surface against
    pallas_scan.score_surface(exact=True) in interpret mode, within the
    port's bound with dq_rel plus the reference's exact-surface bound."""
    queries, codes, norms, valid = _corpus(d=d, q=8, seed=10 + d, bits=bits)
    got = _emulate_i8_surface(queries, codes, norms, valid, metric,
                              bits).numpy()
    ref = np.asarray(jscan.score_surface(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, block_n=1024,
        exact=True, interpret=True))
    assert np.isinf(got[:, SEG * 3:SEG * 4]).all()
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric, bits) +
                   _jax_delta(queries, norms, valid, metric, bf16=False,
                              bits=bits))


def _near_tie_cut(surf, surr, delta_base, delta_wide):
    """(kk, margin) whose cut lands between the flag's two bounds: the
    (kk+margin)-th smallest surface value s_max exceeds the kk-th smallest
    reranked surrogate among the selected rows by more than 1.1 x the
    bound without slicing error and by less than 1.1 x the bound with it
    (a quarter of that window clear of each end)."""
    order = torch.argsort(surf)
    lo, hi = 1.1 * delta_base, 1.1 * delta_wide
    for kk in range(100, 800):
        for margin in range(1, 64):
            s = kk + margin
            gap = float(surf[order[s - 1]]) - float(
                torch.kthvalue(surr[order[:s]], kk).values)
            if gap > hi:
                break
            if lo + (hi - lo) / 4 < gap < hi - (hi - lo) / 4:
                return kk, margin
    raise AssertionError("no cut between the two bounds on this corpus")


@pytest.mark.parametrize("metric", METRICS)
def test_surface_topk_flag_takes_the_routes_dq_rel(monkeypatch, metric):
    """surface_topk (the non-fused K4 branch) must bound its cut with the
    dq_rel of the route that computed the surface.  _score_surface stands
    in for the int8 route: the emulated surface with slice_queries' dq_rel,
    for a query whose last slice leaves half-unit remainders (q_0 = 1 sets
    the scale to 2^-6, so that unit is 2^-20).  At a near-tie cut the
    widened bound must refuse the proof that the bound without the slicing
    error would give, and escalating the margin proves the rows of the
    complete selection."""
    rng = np.random.default_rng(31)
    n, d = 4096, 48
    _, codes, norms = tdist.ingest_reprs(rng.uniform(-1, 1, size=(n, d)), 8)
    valid = np.ones(n, dtype=bool)
    q = np.float32((rng.integers(-8, 8, size=(1, d)) + 0.5) * 2.0 ** -20)
    q[0, 0] = 1.0
    surf = _emulate_i8_surface(q, codes, norms, valid, metric)
    args = [torch.from_numpy(a) for a in (q, codes, norms, valid)]
    dq = tscan.slice_queries(args[0])[2]
    qn2 = args[0].square().sum(-1)
    base, wide = (float(tscan.surface_delta(
        qn2, args[2], args[3], metric=metric, dims=d, dq_rel=x, bits=8)[0])
        for x in (None, dq))
    assert wide > base
    _, surr = tscan._rerank_rows(args[0], torch.arange(n)[None], *args[1:],
                                 bits=8, metric=metric, piece=n)
    kk, margin = _near_tie_cut(surf[0], surr[0], base, wide)

    def route(dq_rel):
        def fake(queries, codes, norms, valid, *, bits, metric, exact=False):
            assert exact and bits == 8
            return surf.clone(), dq_rel
        return fake

    # no slicing error in the bound: this cut would be proven
    monkeypatch.setattr(tscan, "_score_surface", route(None))
    assert tscan.surface_topk(*args, bits=8, metric=metric, k=kk,
                              margin=margin)[2].tolist() == [1]
    # with the route's dq_rel it must not be
    monkeypatch.setattr(tscan, "_score_surface", route(dq))
    assert tscan.surface_topk(*args, bits=8, metric=metric, k=kk,
                              margin=margin)[2].tolist() == [0]
    want = tscan.surface_topk(*args, bits=8, metric=metric, k=kk, margin=n)
    for m in (64, 512, n):
        dist, rows, ok = tscan.surface_topk(*args, bits=8, metric=metric,
                                            k=kk, margin=m)
        if int(ok[0]):
            break
    assert int(ok[0])
    assert torch.equal(rows, want[1]) and torch.equal(dist, want[0])


@pytest.mark.parametrize("bits", BITS)
def test_fused_scan_flag_takes_the_routes_dq_rel(monkeypatch, bits):
    """fused_scan_topk at every segment length (K1 at 32, K5/K6's entry
    point at the others) passes _segment_min's dq_rel, with the codes'
    width, to the flag's bound."""
    queries, codes, norms, valid = _corpus(n=2048, q=3, seed=12, bits=bits)
    args = [torch.from_numpy(a) for a in (queries, codes, norms, valid)]
    dq = tscan.slice_queries(args[0])[2]
    seen = []
    real = tscan.surface_delta

    def spy(*a, dq_rel=None, bits=None, **kw):
        seen.append((dq_rel, bits))
        return real(*a, dq_rel=dq_rel, bits=bits, **kw)

    monkeypatch.setattr(tscan, "surface_delta", spy)
    monkeypatch.setattr(tscan, "_segment_min", lambda *a, seg, **kw: (
        torch.from_numpy(_emulate_i8(queries, codes, norms, valid, "cosine",
                                     seg=seg, bits=bits)), dq))
    for seg in (16, 32, 64, 128):
        tscan.fused_scan_topk(*args, bits=bits, metric="cosine", k=5,
                              seg=seg, with_ties=True)
    assert len(seen) == 4 and all(x is dq and b == bits for x, b in seen)

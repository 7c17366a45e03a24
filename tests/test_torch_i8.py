"""K1's int8 tensor-core route (syzgydb_tpu_torch/csrc/segmin_i8.cu) on the
CPU: the query slicing it runs on (ops/scan.py::slice_queries), a plain
emulation of the kernel's integer arithmetic against the JAX package's
segment-min references, and the flag's bound with the slicing error.

The kernel itself runs only on the card (tests/test_torch_cuda.py).  Here
its arithmetic is emulated exactly as it is done there: int64 products of
the int8 slices with the codes, the exact combine A_0 2^14 + A_1 2^7 + A_2,
one rounding to f32, and the f32 surrogate epilogue with the unrounded
query's |q|^2 and sum.  Tolerances: the emulation and the JAX references
each lie within their own surface bound of the exact surface, so the two
may differ by the sum of the bounds (the port's surface_delta with the
slicing error dq_rel, and the reference's with its bf16 query rounding or
none for its exact surface); against an exact evaluation of the same
formula on q_hat the emulation lies within 4 f32 ulps of the surrogate's
terms (i8_term_scale)."""

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
ULP = 2.0 ** -24


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


def _corpus(n=4096, d=48, q=5, seed=0):
    """8-bit codes with zero rows, invalid rows and a wholly invalid
    segment; a zero query rides along."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, size=(n, d))
    db[7] = 0.0
    db[100:103] = 0.0
    _, codes, norms = tdist.ingest_reprs(db, 8)
    valid = np.ones(n, dtype=bool)
    valid[SEG * 3:SEG * 4] = False
    valid[rng.choice(n, 40, replace=False)] = False
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    queries[-1] = 0.0
    return queries, codes, norms, valid


def _emulate_i8(queries, codes, norms, valid, metric):
    """The int8 route's arithmetic in plain PyTorch: int64 products of the
    slices with the codes, the exact combine, one rounding to f32, the f32
    epilogue with the f32 affine constants the kernel is passed."""
    tq = torch.from_numpy(queries)
    d = queries.shape[1]
    slices, scale, _ = tscan.slice_queries(tq)
    c = torch.from_numpy(codes).to(torch.int64)
    a0, a1, a2 = (slices[i, :, :d].to(torch.int64) @ c.T for i in range(3))
    v = a0 * 16384 + a1 * 128 + a2  # exact: |v| < 2^45
    raw = (v.double() * (scale.double() * 2.0 ** -14)[:, None]).float()
    aff_s, aff_o = (torch.tensor(x, dtype=torch.float32)
                    for x in tqz.affine_constants(8))
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
    s = torch.where(torch.from_numpy(valid)[None, :], s,
                    torch.full_like(s, np.inf))
    return s.reshape(len(queries), -1, SEG).amin(-1).numpy()


def _port_delta(queries, norms, valid, metric):
    tq, tn, tv = (torch.from_numpy(a) for a in (queries, norms, valid))
    dq = tscan.slice_queries(tq)[2]
    return tscan.surface_delta(tq.square().sum(-1), tn, tv, metric=metric,
                               dims=queries.shape[1], dq_rel=dq,
                               bits=8).numpy()[:, None]


def _jax_delta(queries, norms, valid, metric, bf16: bool):
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
        jnp.asarray(valid), bits=8, metric=metric, dims=d,
        eps=jscan.surface_accum_eps(d)))[:, None]


def _assert_within(got, want, tol):
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64))
    assert (err <= np.broadcast_to(tol, got.shape)[fin]).all(), \
        float(err.max())


@pytest.mark.parametrize("metric", METRICS)
def test_emulation_matches_jax_ilv_kernel(metric):
    queries, codes, norms, valid = _corpus(seed=5)
    got = _emulate_i8(queries, codes, norms, valid, metric)
    assert np.isinf(got[:, 3]).all()  # the wholly invalid segment
    ref = np.asarray(jscan.segment_min_scan_ilv(
        jnp.asarray(queries), jnp.asarray(jscan.make_ilv_codes(codes)),
        jnp.asarray(norms), jnp.asarray(valid), bits=8, metric=metric,
        interpret=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric) +
                   _jax_delta(queries, norms, valid, metric, bf16=True))


@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
def test_emulation_matches_jax_exact_surface(metric, d):
    queries, codes, norms, valid = _corpus(d=d, seed=6)
    got = _emulate_i8(queries, codes, norms, valid, metric)
    ref = np.asarray(jscan.segment_min_scan_xla(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=8, metric=metric, exact=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric) +
                   _jax_delta(queries, norms, valid, metric, bf16=False))


@pytest.mark.parametrize("d", [48, 33, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_emulation_within_ulps_of_exact_on_q_hat(metric, d):
    """The tight check the card holds the kernel to: an f64 evaluation on
    q_hat with the unrounded query's |q|^2 and sum, 4 f32 ulps of the
    surrogate's terms, identical +inf positions."""
    queries, codes, norms, valid = _corpus(n=2048, d=d, seed=7)
    got = _emulate_i8(queries, codes, norms, valid, metric)
    tq, tc, tn, tv = (torch.from_numpy(a) for a in
                      (queries, codes, norms, valid))
    slices, scale, _ = tscan.slice_queries(tq)
    qhat = tscan.unslice_queries(slices, scale)[:, :d]
    qn2 = tq.square().sum(-1)
    want = tscan.segment_min_scan_plain(
        qhat, tc, tn, tv, bits=8, metric=metric, dtype=torch.float64,
        query_terms=(qn2, tq.sum(-1))).numpy()
    tol = 4 * ULP * tscan.i8_term_scale(qn2, tn, tv, metric=metric,
                                        dims=d).double().numpy()[:, None]
    _assert_within(got, want, tol)
    # and within the flag's bound of the exact surface on the unrounded q
    exact = tscan.segment_min_scan_plain(tq, tc, tn, tv, bits=8,
                                         metric=metric,
                                         dtype=torch.float64).numpy()
    _assert_within(got, exact, _port_delta(queries, norms, valid, metric))


@pytest.mark.parametrize("d", [33, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_surface_delta_with_dq_rel_matches_jax(metric, d):
    queries, _, norms, valid = _corpus(n=1024, d=d, seed=8)
    tq, tn, tv = (torch.from_numpy(a) for a in (queries, norms, valid))
    dq = tscan.slice_queries(tq)[2]
    qn2 = tq.square().sum(-1)
    port = tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d,
                               dq_rel=dq, bits=8).numpy()
    ref = np.asarray(jscan.surface_delta(
        jnp.asarray(dq.numpy()), jnp.asarray(qn2.numpy()), jnp.asarray(norms),
        jnp.asarray(valid), bits=8, metric=metric, dims=d,
        eps=jscan.surface_accum_eps(d)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    # without dq_rel: the f32 cushion alone, as before
    base = tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d).numpy()
    assert (port >= base).all()
    np.testing.assert_array_equal(
        tscan.surface_delta(qn2, tn, tv, metric=metric, dims=d,
                            dq_rel=torch.zeros_like(dq), bits=8).numpy(),
        base)


def test_surface_delta_needs_bits_with_dq_rel():
    q = torch.ones(2)
    with pytest.raises(ValueError, match="bits"):
        tscan.surface_delta(q, q, torch.ones(2, dtype=torch.bool),
                            metric="cosine", dims=4, dq_rel=q)


def test_cpu_route_carries_no_slicing_error():
    """On the CPU the plain version runs on the unrounded queries: no
    dq_rel, so the flag's bound (and the fused scan's results) stay as
    they were."""
    queries, codes, norms, valid = _corpus(n=1024, q=3, seed=9)
    args = [torch.from_numpy(a) for a in (queries, codes, norms, valid)]
    out, dq = tscan._segment_min(*args, bits=8, metric="cosine",
                                 seg=SEG)
    assert dq is None
    np.testing.assert_array_equal(
        out.numpy(), tscan.segment_min_scan_plain(
            *args, bits=8, metric="cosine").numpy())

"""The int8 tensor-core route (syzgydb_tpu_torch/csrc/segmin_i8.cu: K1,
K5/K6 and K4 on 8-bit codes) on the CPU: the query slicing it runs on
(ops/scan.py::slice_queries), a plain emulation of the kernel's integer
arithmetic against the JAX package's segment-min and surface references,
and the flags' bound with the slicing error (fused_scan_topk and
surface_topk).

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


def _emulate_i8_surface(queries, codes, norms, valid, metric):
    """The int8 route's arithmetic in plain PyTorch, as the full (Q, N) f32
    surface K4 writes: int64 products of the slices with the codes, the
    exact combine, one rounding to f32, the f32 epilogue with the f32
    affine constants the kernel is passed."""
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
    return torch.where(torch.from_numpy(valid)[None, :], s,
                       torch.full_like(s, np.inf))


def _emulate_i8(queries, codes, norms, valid, metric, seg=SEG):
    """The int8 route's segment minima (K1 at seg 32, K5/K6 at 16/64/128),
    folded from the emulated surface."""
    s = _emulate_i8_surface(queries, codes, norms, valid, metric)
    return s.reshape(len(queries), -1, seg).amin(-1).numpy()


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


@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seg", [16, 64, 128])
@pytest.mark.parametrize("kernel", ["segment_min_scan",
                                    "segment_min_scan_nat"])
def test_emulation_matches_superseded_free_seg_kernels(superseded, kernel,
                                                       seg, metric, d):
    """K5/K6 on the int8 route: the emulation's minima at seg 16/64/128
    against the archived TPU kernels in interpret mode (which round
    queries to bf16 for 8-bit codes), within the sum of the two bounds."""
    queries, codes, norms, valid = _corpus(d=d, q=8, seed=seg + d)
    valid[128 * 5:128 * 6] = False  # a wholly invalid segment at every seg
    got = _emulate_i8(queries, codes, norms, valid, metric, seg=seg)
    assert got.shape == (8, 4096 // seg)
    assert np.isinf(got[:, 128 * 5 // seg:128 * 6 // seg]).all()
    ref = np.asarray(getattr(superseded, kernel)(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=8, metric=metric, block_n=1024, seg=seg,
        interpret=True))
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric) +
                   _jax_delta(queries, norms, valid, metric, bf16=True))


@pytest.mark.parametrize("d", [48, 33])
@pytest.mark.parametrize("metric", METRICS)
def test_emulated_surface_matches_jax_surface_kernel(metric, d):
    """K4 on the int8 route: the emulated f32 surface against
    pallas_scan.score_surface(exact=True) in interpret mode, within the
    port's bound with dq_rel plus the reference's exact-surface bound."""
    queries, codes, norms, valid = _corpus(d=d, q=8, seed=10 + d)
    got = _emulate_i8_surface(queries, codes, norms, valid, metric).numpy()
    ref = np.asarray(jscan.score_surface(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=8, metric=metric, block_n=1024, exact=True,
        interpret=True))
    assert np.isinf(got[:, SEG * 3:SEG * 4]).all()
    _assert_within(got, ref,
                   _port_delta(queries, norms, valid, metric) +
                   _jax_delta(queries, norms, valid, metric, bf16=False))


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


def test_fused_scan_flag_takes_the_routes_dq_rel(monkeypatch):
    """fused_scan_topk at a free segment length (K5/K6's entry point) passes
    _segment_min's dq_rel to the flag's bound, as at seg 32."""
    queries, codes, norms, valid = _corpus(n=2048, q=3, seed=12)
    args = [torch.from_numpy(a) for a in (queries, codes, norms, valid)]
    dq = tscan.slice_queries(args[0])[2]
    seen = []
    real = tscan.surface_delta

    def spy(*a, dq_rel=None, **kw):
        seen.append(dq_rel)
        return real(*a, dq_rel=dq_rel, **kw)

    monkeypatch.setattr(tscan, "surface_delta", spy)
    monkeypatch.setattr(tscan, "_segment_min", lambda *a, seg, **kw: (
        torch.from_numpy(_emulate_i8(queries, codes, norms, valid, "cosine",
                                     seg=seg)), dq))
    for seg in (16, 64, 128):
        tscan.fused_scan_topk(*args, bits=8, metric="cosine", k=5, seg=seg,
                              with_ties=True)
    assert len(seen) == 3 and all(x is dq for x in seen)

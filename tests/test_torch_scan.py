"""The port's segment-min scan and select-and-rerank (syzgydb_tpu_torch/
ops/scan.py) against the JAX package's (syzgydb_tpu/ops/pallas_scan.py).

The JAX side runs its Pallas kernel in interpret mode on the CPU (and its
exact XLA surface); the port runs the plain version of kernel K1, which is
what a CPU tensor gets.  Inputs are made with numpy from a seed and handed
to both.  Tolerances, in surrogate units, come from the completeness flag's
own error bounds (surface_delta): the reference surface rounds queries to
bf16 (and splits 32/64-bit codes into bf16 pairs) and bounds that with the
JAX package's surface_delta, the port's surface rounds neither, so the two
may differ by the reference's delta plus the port's, and the port's f32
surface may differ from an f64 evaluation of the same formula by the
port's delta (the f32 accumulation cushion) alone.  The port's flag uses
its own delta, so it proves every query the reference proves and may
prove more; where it proves one, the rows are the true top-k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syzgydb_tpu.ops import distance as jdist
from syzgydb_tpu.ops import pallas_scan as jscan
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import scan as tscan

SEG = tscan.DEFAULT_SEG
WIDTHS = [4, 8, 16, 32, 64]
METRICS = ["euclidean", "cosine"]


def _corpus(bits, n=4096, d=48, q=5, seed=0):
    """Uniform vectors with zero rows, invalid rows and a wholly invalid
    segment; a zero query rides along.  4-bit uses an odd D."""
    rng = np.random.default_rng(seed)
    if bits == 4:
        d -= 1
    db = rng.uniform(-1, 1, size=(n, d))
    db[7] = 0.0
    db[100:103] = 0.0
    _, codes, norms = tdist.ingest_reprs(db, bits)
    if bits == 64:
        codes = np.float32(codes)
    valid = np.ones(n, dtype=bool)
    valid[SEG * 3:SEG * 4] = False
    valid[rng.choice(n, 40, replace=False)] = False
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    queries[-1] = 0.0
    return queries, codes, norms, valid


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _delta(queries, norms, valid, bits, metric, reference: bool):
    """Per-query surface error bound: the reference surface's (the JAX
    package's surface_delta with its bf16 query rounding and code split)
    or the port's (accumulation cushion only)."""
    q, n, v = _torch(queries, norms, valid)
    d = queries.shape[1]
    qn2 = q.square().sum(-1)
    if not reference:
        return tscan.surface_delta(qn2, n, v, metric=metric,
                                   dims=d).numpy()[:, None]
    dq = (q - q.to(torch.bfloat16).float()).square().sum(-1).sqrt()
    dq_rel = torch.where(qn2 > 0, dq * torch.rsqrt(qn2.clamp_min(1e-30)),
                         torch.ones_like(qn2))
    jax_bits = 32 if bits == 64 else bits
    return np.asarray(jscan.surface_delta(
        jnp.asarray(dq_rel.numpy()), jnp.asarray(qn2.numpy()),
        jnp.asarray(norms), jnp.asarray(valid), bits=jax_bits, metric=metric,
        dims=d, eps=jscan.surface_accum_eps(d),
        dc_rel=jscan._CODE_SPLIT_REL if bits in (32, 64) else 0.0))[:, None]


def _jax_full_topk(queries, codes, norms, valid, bits, metric, k):
    """The JAX package's exact (HIGHEST-precision f32) full distance
    matrix and its top-k: (dist, rows) as numpy."""
    full = jdist.score_block(jnp.asarray(queries), jnp.asarray(codes),
                             jnp.asarray(norms), jnp.asarray(valid),
                             32 if bits == 64 else bits, metric, exact=True)
    return [np.asarray(o) for o in jdist.top_k_smallest(full, k)]


def _assert_within(got, want, tol):
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64))
    assert (err <= np.broadcast_to(tol, got.shape)[fin]).all(), \
        float(err.max())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", WIDTHS)
def test_plain_segmin_matches_jax_ilv_and_f64(bits, metric):
    queries, codes, norms, valid = _corpus(bits)
    tq, tc, tn, tv = _torch(queries, codes, norms, valid)
    port = tscan.segment_min_scan(tq, tc, tn, tv, bits=bits,
                                  metric=metric).numpy()
    assert port.shape == (len(queries), len(norms) // SEG)
    assert port.dtype == np.float32
    # the wholly invalid segment is +inf
    assert np.isinf(port[:, 3]).all()

    jax_bits = 32 if bits == 64 else bits
    ilv = jnp.asarray(jscan.make_ilv_codes(codes))
    ref = np.asarray(jscan.segment_min_scan_ilv(
        jnp.asarray(queries), ilv, jnp.asarray(norms), jnp.asarray(valid),
        bits=jax_bits, metric=metric, interpret=True))
    _assert_within(port, ref,
                   _delta(queries, norms, valid, bits, metric, True) +
                   _delta(queries, norms, valid, bits, metric, False))

    # the same formula in f64: the port's f32 error is inside the cushion
    f64 = tscan.segment_min_scan_plain(tq, tc, tn, tv, bits=bits,
                                       metric=metric,
                                       dtype=torch.float64).numpy()
    _assert_within(port, f64,
                   _delta(queries, norms, valid, bits, metric, False))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_plain_segmin_matches_jax_exact_xla(bits, metric):
    queries, codes, norms, valid = _corpus(bits, seed=1)
    port = tscan.segment_min_scan(*_torch(queries, codes, norms, valid),
                                  bits=bits, metric=metric).numpy()
    ref = np.asarray(jscan.segment_min_scan_xla(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric=metric, exact=True))
    # both f32 with unrounded queries: two accumulation cushions apart
    _assert_within(port, ref,
                   2 * _delta(queries, norms, valid, bits, metric, False))


def _jax_fused(queries, codes, norms, valid, bits, metric, k, **kw):
    out = jscan.fused_scan_topk(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), codes_ilv=jnp.asarray(jscan.make_ilv_codes(codes)),
        bits=32 if bits == 64 else bits, metric=metric, k=k, interpret=True,
        with_ties=True, **kw)
    return [np.asarray(o) for o in out]


def _port_fused(queries, codes, norms, valid, bits, metric, k, **kw):
    # the port has one surface at every precision: no `exact` argument
    out = tscan.fused_scan_topk(*_torch(queries, codes, norms, valid),
                                bits=bits, metric=metric, k=k,
                                with_ties=True, **kw)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", WIDTHS)
def test_fused_scan_topk_matches_jax(bits, metric, exact):
    queries, codes, norms, valid = _corpus(bits, seed=2)
    k = 10
    jd, jr, jok = _jax_fused(queries, codes, norms, valid, bits, metric, k,
                             exact=exact)
    pd, pr, pok = _port_fused(queries, codes, norms, valid, bits, metric, k)
    # the port's delta is the reference's exact-surface delta: it proves
    # every query the reference proves, and the same ones where the
    # reference's surface is exact too
    assert (pok >= jok).all()
    if exact:
        np.testing.assert_array_equal(pok, jok)
    # both rerank in exact f32: distances agree to f32 rounding
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-6)
    real = np.flatnonzero(np.any(queries != 0.0, axis=1))
    # where the port's flag holds on a real query (a zero query ties every
    # row), its rows are the true top-k
    _, want_r = _jax_full_topk(queries, codes, norms, valid, bits, metric, k)
    for i in np.intersect1d(real, np.flatnonzero(pok)):
        assert set(pr[i].tolist()) == set(want_r[i].tolist())
    for i in real:
        assert set(pr[i].tolist()) == set(jr[i].tolist())
    # ties in value come back ordered by row
    for i in range(len(queries)):
        order = np.lexsort((pr[i], pd[i]))
        np.testing.assert_array_equal(order, np.arange(k))


def _tie_corpus(n, d, n_ties, tie_lo_seg):
    """tests/test_provable_high.py's adversarial corpus: one special row per
    tied segment, true rank improving with the segment index."""
    rng = np.random.default_rng(9)
    bg = rng.standard_normal((n, d)).astype(np.float32)
    bg /= np.linalg.norm(bg, axis=1, keepdims=True)
    db = bg
    db[:, 0] = np.abs(db[:, 0]) * 0.2
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    for i in range(n_ties):
        row = (tie_lo_seg + i) * SEG
        cos = 0.7 + i * 1e-6
        db[row] = 0.0
        db[row, 0] = cos
        db[row, 1] = np.sqrt(1.0 - cos * cos)
    q = np.zeros((1, d), dtype=np.float32)
    q[0, 0] = 1.0
    return db, q


@pytest.mark.parametrize("margin", [None, 332])
def test_tie_corpus_flags_and_rows_match_jax(margin):
    n, d, k, n_ties = 65536, 16, 10, 300
    db, q = _tie_corpus(n, d, n_ties, tie_lo_seg=600)
    codes = np.float32(db)
    norms = tdist.db_row_stats(codes, 32)
    valid = np.ones(n, dtype=bool)
    kw = {} if margin is None else {"tie_margin": margin}
    jd, jr, jok = _jax_fused(q, codes, norms, valid, 32, "cosine", k, **kw)
    pd, pr, pok = _port_fused(q, codes, norms, valid, 32, "cosine", k, **kw)
    np.testing.assert_array_equal(pok, jok)
    # the default margin cannot prove the tie cluster; the wide one can
    assert int(pok[0]) == (0 if margin is None else 1)
    want = [(600 + n_ties - 1 - i) * SEG for i in range(k)]
    if margin is not None:
        assert pr[0].tolist() == want
        assert jr[0].tolist() == want
    np.testing.assert_allclose(pd, jd, rtol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
def test_chunked_gather_returns_the_same_rows(bits):
    queries, codes, norms, valid = _corpus(bits, q=9, seed=3)
    whole = _port_fused(queries, codes, norms, valid, bits, "cosine", 10,
                        tie_margin=64)
    # a budget of one query's candidates forces nine one-query chunks
    d = queries.shape[1]
    one = 4 * (10 + 64 + 1) * SEG * d
    chunked = _port_fused(queries, codes, norms, valid, bits, "cosine", 10,
                          tie_margin=64, gather_bytes=one)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_full_gather_is_complete():
    queries, codes, norms, valid = _corpus(8, n=1024, q=3, seed=4)
    # a margin past the segment count gathers every segment
    d, r, ok = _port_fused(queries, codes, norms, valid, 8, "euclidean", 5,
                           tie_margin=1 << 30)
    assert ok.tolist() == [1, 1, 1]
    want_d, want_r = _jax_full_topk(queries, codes, norms, valid, 8,
                                    "euclidean", 5)
    np.testing.assert_allclose(d, want_d, rtol=1e-6)
    np.testing.assert_array_equal(r, want_r)


def test_kernel_wrapper_rejects_bad_input():
    queries, codes, norms, valid = _corpus(8, n=1024, q=2)
    tq, tc, tn, tv = _torch(queries, codes, norms, valid)
    with pytest.raises(TypeError):
        tscan.segment_min_scan(tq, tc.to(torch.int16), tn, tv, bits=8,
                               metric="cosine")
    with pytest.raises(ValueError):
        tscan.segment_min_scan(tq, tc[:1000], tn[:1000], tv[:1000], bits=8,
                               metric="cosine")
    with pytest.raises(ValueError):
        tscan.fused_scan_topk(tq, tc, tn, tv, bits=8, metric="cosine",
                              k=2000)

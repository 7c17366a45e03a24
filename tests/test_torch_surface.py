"""Kernel K4 (the full surrogate surface, ops/scan.py score_surface) and
the K5/K6 port (segment_min_scan at a free segment length) against the JAX
package's Pallas kernels, run in interpret mode on the CPU: K4 against
pallas_scan.score_surface, K5/K6 against tools_dev/superseded_kernels.py's
segment_min_scan (transposed layout) and segment_min_scan_nat (natural
layout), loaded by file path.  The port's CPU tensors run the plain
versions of its kernels.

Tolerances, in surrogate units, come from the completeness flag's error
bounds (surface_delta).  The port rounds neither queries nor codes, so its
f32 values lie within the port's delta (the f32 accumulation cushion) of
an f64 evaluation.  The reference kernels round queries to bf16 for 4- and
8-bit codes outside exact mode; their delta is the JAX package's
surface_delta with that query rounding (dq_rel) and no code split, since
neither kernel splits codes.  So:

  * exact (f32 on both sides, no rounding): twice the port's delta;
  * f32 port vs a reference that may round queries: the reference's delta
    plus the port's;
  * bf16 surfaces: that sum plus one bf16 half-ulp of the value on each
    side (both round an f32 value to nearest).

The +inf positions (invalid rows, wholly invalid segments) must be
identical."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syzgydb_tpu.ops import distance as jdist
from syzgydb_tpu.ops import pallas_scan as jscan
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import scan as tscan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = [4, 8, 16, 32, 64]
METRICS = ["euclidean", "cosine"]


@pytest.fixture(scope="module")
def superseded():
    """tools_dev/superseded_kernels.py, loaded by path (it is no package
    module and stays unedited)."""
    path = os.path.join(ROOT, "tools_dev", "superseded_kernels.py")
    spec = importlib.util.spec_from_file_location("superseded_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _corpus(bits, n=4096, d=48, q=8, seed=0):
    """Uniform vectors with zero rows, invalid rows and a wholly invalid
    128-row block; a zero query rides along.  4-bit uses an odd D."""
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
    valid[128 * 3:128 * 4] = False
    valid[rng.choice(n, 40, replace=False)] = False
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    queries[-1] = 0.0
    return queries, codes, norms, valid


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _port_delta(queries, norms, valid, metric):
    q, n, v = _torch(queries, norms, valid)
    return tscan.surface_delta(q.square().sum(-1), n, v, metric=metric,
                               dims=queries.shape[1]).numpy()[:, None]


def _ref_delta(queries, norms, valid, bits, metric, rounds_queries: bool):
    """The JAX package's surface_delta for a kernel that rounds queries to
    bf16 (rounds_queries) or computes in f32, with no code split."""
    q = torch.from_numpy(queries)
    qn2 = q.square().sum(-1)
    if rounds_queries:
        dq = (q - q.to(torch.bfloat16).float()).square().sum(-1).sqrt()
        dq_rel = torch.where(qn2 > 0, dq * torch.rsqrt(qn2.clamp_min(1e-30)),
                             torch.ones_like(qn2))
    else:
        dq_rel = torch.zeros_like(qn2)
    d = queries.shape[1]
    return np.asarray(jscan.surface_delta(
        jnp.asarray(dq_rel.numpy()), jnp.asarray(qn2.numpy()),
        jnp.asarray(norms), jnp.asarray(valid),
        bits=32 if bits == 64 else bits, metric=metric, dims=d,
        eps=jscan.surface_accum_eps(d)))[:, None]


def _half_ulp_bf16(x):
    """Half a bf16 unit in the last place at |x| (8 significant bits)."""
    ax = np.abs(np.asarray(x, dtype=np.float64))
    e = np.floor(np.log2(np.where(ax > 0, ax, 1.0)))
    return np.where(ax > 0, 2.0 ** (e - 8), 0.0)


def _assert_within(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    bound = np.broadcast_to(tol, got.shape)[fin]
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", WIDTHS)
def test_plain_surface_matches_jax_surface_kernel(bits, metric, exact):
    queries, codes, norms, valid = _corpus(bits, seed=bits)
    tq, tc, tn, tv = _torch(queries, codes, norms, valid)
    port = tscan.score_surface(tq, tc, tn, tv, bits=bits, metric=metric,
                               exact=exact)
    assert port.shape == (len(queries), len(norms))
    assert port.dtype == (torch.float32 if exact else torch.bfloat16)
    port = port.float().numpy()
    assert np.isinf(port[:, 128 * 3:128 * 4]).all()

    ref = np.asarray(jscan.score_surface(
        *_jax(queries, codes, norms, valid), bits=32 if bits == 64 else bits,
        metric=metric, block_n=1024, exact=exact, interpret=True),
        dtype=np.float32)
    pdelta = _port_delta(queries, norms, valid, metric)
    if exact:
        _assert_within(port, ref, 2 * pdelta)
    else:
        tol = _ref_delta(queries, norms, valid, bits, metric,
                         rounds_queries=bits in (4, 8)) + pdelta
        _assert_within(port, ref, tol + _half_ulp_bf16(port) +
                       _half_ulp_bf16(ref))

    # the port's f32 surface is within its own delta of an f64 evaluation
    f32 = tscan.score_surface(tq, tc, tn, tv, bits=bits, metric=metric,
                              exact=True).numpy()
    f64 = tscan.score_surface_plain(tq, tc, tn, tv, bits=bits, metric=metric,
                                    dtype=torch.float64).numpy()
    _assert_within(f32, f64, pdelta)
    # and the bf16 surface is that f32 surface rounded to nearest
    if not exact:
        np.testing.assert_array_equal(
            port, torch.from_numpy(f32).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("kernel", ["segment_min_scan", "segment_min_scan_nat"])
@pytest.mark.parametrize("seg", [16, 32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8, 16, 64])
def test_free_seg_segmin_matches_superseded_kernels(superseded, kernel, seg,
                                                    bits):
    metric = "cosine" if bits in (8, 64) else "euclidean"
    queries, codes, norms, valid = _corpus(bits, seed=20 + seg)
    tq, tc, tn, tv = _torch(queries, codes, norms, valid)
    port = tscan.segment_min_scan(tq, tc, tn, tv, bits=bits, metric=metric,
                                  seg=seg).numpy()
    assert port.shape == (len(queries), len(norms) // seg)
    assert np.isinf(port[:, 128 * 3 // seg:128 * 4 // seg]).all()

    ref = np.asarray(getattr(superseded, kernel)(
        *_jax(queries, codes, norms, valid), bits=32 if bits == 64 else bits,
        metric=metric, block_n=1024, seg=seg, interpret=True))
    tol = _ref_delta(queries, norms, valid, bits, metric,
                     rounds_queries=bits in (4, 8)) + \
        _port_delta(queries, norms, valid, metric)
    _assert_within(port, ref, tol)

    # the segment minima are the surface's, folded over each segment
    surf = tscan.score_surface(tq, tc, tn, tv, bits=bits, metric=metric,
                               exact=True)
    np.testing.assert_array_equal(
        port, surf.reshape(len(queries), -1, seg).amin(-1).numpy())


def test_free_seg_fused_scan_returns_the_seg32_rows():
    """fused_scan_topk at another segment length proves and returns the
    same top-k as at the default 32 (complete flags on this corpus)."""
    queries, codes, norms, valid = _corpus(8, seed=5)
    args = _torch(queries[:-1], codes, norms, valid)
    base = tscan.fused_scan_topk(*args, bits=8, metric="cosine", k=10,
                                 with_ties=True)
    assert bool(base[2].all())
    for seg in (16, 64, 128):
        d, r, ok = tscan.fused_scan_topk(*args, bits=8, metric="cosine", k=10,
                                         seg=seg, with_ties=True,
                                         tie_margin=64)
        assert bool(ok.all())
        np.testing.assert_array_equal(r.numpy(), base[1].numpy())
        np.testing.assert_allclose(d.numpy(), base[0].numpy(), rtol=1e-6)


def test_surface_topk_matches_full_sort():
    """The non-fused selection: K4's surface, topk, the rerank's own
    formula and (distance, row) order, in query chunks and rerank pieces of
    any size, against the JAX package's exact full distance matrix."""
    queries, codes, norms, valid = _corpus(16, n=2048, q=9, seed=6)
    args = _torch(queries, codes, norms, valid)
    full = jdist.score_block(*_jax(queries, codes, norms, valid), 16,
                             "euclidean", exact=True)
    want_d, want_r = [np.asarray(o) for o in jdist.top_k_smallest(full, 300)]
    # the zero rows tie in value: the port orders ties by row, lax.top_k
    # promises no order among them
    order = np.lexsort((want_r, want_d), axis=1)
    want_d = np.take_along_axis(want_d, order, 1)
    want_r = np.take_along_axis(want_r, order, 1)
    d, r, ok = tscan.surface_topk(*args, bits=16, metric="euclidean", k=300,
                                  margin=64)
    assert ok.tolist() == [1] * 9
    np.testing.assert_array_equal(r.numpy(), want_r)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-6)
    # a budget of one query per chunk, and candidates reranked a few dozen
    # at a time, returns the same rows and flags; the distances hold to the
    # reference as tightly (a piece's shape may change the contraction's
    # f32 summation order)
    budget = 2 * tscan.surface_query_bytes(2048, 364)
    assert tscan.surface_chunk(9, 2048, 364, budget) == 1
    assert tscan.rerank_piece(1, queries.shape[1], budget) < 364 // 4
    d1, r1, ok1 = tscan.surface_topk(*args, bits=16, metric="euclidean",
                                     k=300, margin=64, budget_bytes=budget)
    np.testing.assert_array_equal(r1.numpy(), r.numpy())
    np.testing.assert_array_equal(ok1.numpy(), ok.numpy())
    np.testing.assert_allclose(d1.numpy(), want_d, rtol=1e-6)


def test_surface_chunk_rounds_to_kernel_tiles():
    assert tscan.surface_chunk(1024, 1 << 18, 4096) % 128 == 0
    assert tscan.surface_chunk(1024, 1 << 18, 4096) > 128
    assert tscan.surface_chunk(5, 1 << 20, 4096) == 5
    assert tscan.surface_chunk(1024, 1 << 30, 4096) == 1


def test_kernel_segs_reject_other_lengths_on_cuda_only():
    """CPU tensors run the plain version at any segment length; the CUDA
    wrapper's refusal of other lengths names the four it is built for."""
    queries, codes, norms, valid = _corpus(8, n=960, q=2)
    out = tscan.segment_min_scan(*_torch(queries, codes, norms, valid),
                                 bits=8, metric="cosine", seg=48)
    assert out.shape == (2, 20)
    assert tscan.KERNEL_SEGS == (16, 32, 64, 128)

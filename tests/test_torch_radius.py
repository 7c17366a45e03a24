"""Radius search on the port's Collection (syzgydb_tpu_torch, device="cpu")
against the JAX package's on identical inserts.

HOST_SCAN_MAX_ELEMS is patched in both packages where a case must reach
the device branch (the JAX package then selects over its XLA f32 surface
on the CPU; the port runs the plain versions of its kernels).  The cases
are those of tests/test_collection.py (radius), tests/test_batching.py
(mixed radii in one group, filter_query, rejection of heterogeneous
groups) and tests/test_provable_high.py (large-k dispatches never set the
margin hint), plus a group of more than 64 queries and a radius holding
more than 1024 rows: both run the port's non-fused branch (scan.
surface_topk over kernel K4's surface).

Ids are compared as sets (the order of rows tied at one distance is not a
fault).  Distances: exact mode and the host scan re-rank in f64 on both
sides and must be equal; high mode reranks in f32 on both sides, so the
two may differ by twice the rerank's f32 accumulation cushion
(scan.surface_accum_eps) in surrogate units — squared euclidean scaled by
|q|^2 + max |v|^2, or (1 - cos)/2.  Medium (sketch candidates) holds the
port to the JAX package's recall of the exact in-radius set."""

import json

import numpy as np
import pytest
import torch

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.core import collection as jcoll
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.ops import scan as tscan


@pytest.fixture
def device_paths(monkeypatch):
    monkeypatch.setattr(jcoll, "HOST_SCAN_MAX_ELEMS", 0)
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    return monkeypatch


@pytest.fixture
def surface_calls(monkeypatch):
    """Counts the port's non-fused selections (K4 branch) and records the
    (k, Q) of its fused dispatches."""
    calls = {"surface": 0, "fused": []}
    real_surface, real_fused = tscan.surface_topk, tscan.fused_scan_topk

    def surface(queries, *a, **kw):
        calls["surface"] += 1
        return real_surface(queries, *a, **kw)

    def fused(queries, *a, **kw):
        calls["fused"].append((kw["k"], queries.shape[0]))
        return real_fused(queries, *a, **kw)

    monkeypatch.setattr(tscan, "surface_topk", surface)
    monkeypatch.setattr(tscan, "fused_scan_topk", fused)
    return calls


def _pair(tmp_path, n=600, dims=16, metric=jdb.COSINE, bits=8, seed=13,
          vecs=None, **opts):
    """Both packages' collections on the same documents (metadata
    {"i": id}), as tests/test_batching.py's make_coll."""
    if vecs is None:
        vecs = np.random.default_rng(seed).uniform(-1, 1, size=(n, dims))
    out = []
    for pkg, name, kw in ((jdb, "jax.dat", {}),
                          (tdb, "port.dat", {"device": "cpu"})):
        c = pkg.Collection(pkg.CollectionOptions(
            name=str(tmp_path / name), distance_method=metric,
            dimension_count=vecs.shape[1], quantization=bits,
            create_and_overwrite=True, index_seed=13, **opts), **kw)
        c.add_documents(list(range(len(vecs))), vecs,
                        [json.dumps({"i": i}).encode()
                         for i in range(len(vecs))])
        out.append(c)
    return out[0], out[1], vecs


def _surr(d, metric):
    d = np.asarray(d, dtype=np.float64)
    return d * d if metric == jdb.EUCLIDEAN else (1.0 - np.cos(np.pi * d)) / 2


def _same(a, b, *, exact, metric, dims, scale=1.0):
    """Same id set and percent_searched; distances equal (f64 on both
    sides) or within twice the f32 cushion in surrogate units."""
    assert {r.id for r in a.results} == {r.id for r in b.results}
    assert len(a.results) == len(b.results)
    assert a.percent_searched == b.percent_searched
    da = sorted(r.distance for r in a.results)
    dbb = sorted(r.distance for r in b.results)
    if exact:
        assert da == dbb
    else:
        tol = 2 * tscan.surface_accum_eps(dims) * scale
        np.testing.assert_allclose(_surr(dbb, metric), _surr(da, metric),
                                   rtol=0, atol=tol)
    # results come back in ascending distance
    got = [r.distance for r in b.results]
    assert got == sorted(got)


def _scale(metric, q, vecs):
    if metric == jdb.COSINE:
        return 1.0
    return float(np.sum(q * q) + np.max(np.sum(vecs * vecs, axis=1)))


def test_radius_search_host_scan(tmp_path):
    """tests/test_collection.py's 2-d euclidean case (host f64 scan)."""
    pts = np.array([(0.0, 0.0), (0.1, 0.0), (0.0, 0.2), (0.5, 0.5),
                    (0.9, 0.9)])
    jc, tc, _ = _pair(tmp_path, vecs=pts, metric=jdb.EUCLIDEAN, bits=64)
    for precision in ("exact", "high", "medium"):
        a = jc.search(jdb.SearchArgs(vector=[0.0, 0.0], radius=0.25,
                                     precision=precision))
        b = tc.search(tdb.SearchArgs(vector=[0.0, 0.0], radius=0.25,
                                     precision=precision))
        assert {r.id for r in b.results} == {0, 1, 2}
        _same(a, b, exact=True, metric=jdb.EUCLIDEAN, dims=2)
    jc.close()
    tc.close()


@pytest.mark.parametrize("precision", ["exact", "high", "medium"])
@pytest.mark.parametrize("force_device", [False, True])
def test_radius_many_matches_jax_and_sequential(tmp_path, monkeypatch,
                                                precision, force_device):
    """tests/test_batching.py's mixed-radii group: the port's batch equals
    its own per-request searches and the JAX package's batch."""
    if force_device:
        monkeypatch.setattr(jcoll, "HOST_SCAN_MAX_ELEMS", 0)
        monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    jc, tc, _ = _pair(tmp_path)
    queries = np.random.default_rng(42).uniform(-1, 1, size=(5, 16))
    radii = [0.2, 0.35, 0.5, 0.2, 0.05]
    jb = jc.radius_many([jdb.SearchArgs(vector=q, radius=r,
                                        precision=precision)
                         for q, r in zip(queries, radii)])
    tb = tc.radius_many([tdb.SearchArgs(vector=q, radius=r,
                                        precision=precision)
                         for q, r in zip(queries, radii)])
    assert len(tb) == 5
    for q, r, a, b in zip(queries, radii, jb, tb):
        s = tc.search(tdb.SearchArgs(vector=q, radius=r, precision=precision))
        assert [x.id for x in b.results] == [x.id for x in s.results]
        np.testing.assert_allclose([x.distance for x in b.results],
                                   [x.distance for x in s.results],
                                   rtol=1e-5, atol=1e-6)
        assert all(x.distance <= r for x in b.results)
        if precision == "medium" and force_device:
            # sketch candidates: the port's exact selection recalls the
            # exact in-radius set at least as well as the JAX package's
            want = {x.id for x in tc.search(tdb.SearchArgs(
                vector=q, radius=r, precision="exact")).results}
            if want:
                rt = len({x.id for x in b.results} & want) / len(want)
                rj = len({x.id for x in a.results} & want) / len(want)
                assert rt >= rj - 1e-9
            assert {x.id for x in b.results} <= want | {
                x.id for x in a.results}
        else:
            # the host scan (high below the threshold) and exact re-rank
            # in f64; the device routes (and medium's index) in f32
            _same(a, b, exact=precision == "exact" or (
                not force_device and precision == "high"),
                metric=jdb.COSINE, dims=16)
    jc.close()
    tc.close()


def test_radius_many_with_filter_query(tmp_path):
    jc, tc, _ = _pair(tmp_path)
    queries = np.random.default_rng(3).uniform(-1, 1, size=(3, 16))
    fq = "i >= 200"
    jb = jc.radius_many([jdb.SearchArgs(vector=q, radius=0.4, filter_query=fq)
                         for q in queries])
    tb = tc.radius_many([tdb.SearchArgs(vector=q, radius=0.4, filter_query=fq)
                         for q in queries])
    for q, a, b in zip(queries, jb, tb):
        s = tc.search(tdb.SearchArgs(vector=q, radius=0.4, filter_query=fq))
        assert [r.id for r in b.results] == [r.id for r in s.results]
        assert b.results and all(r.id >= 200 for r in b.results)
        # medium (the default) rides the index, whose budget covers every
        # row here: the same set, f32 distances
        _same(a, b, exact=False, metric=jdb.COSINE, dims=16)
    jc.close()
    tc.close()


def test_radius_many_rejects_heterogeneous(tmp_path):
    _, tc, _ = _pair(tmp_path, n=20)
    q = np.random.default_rng(4).uniform(-1, 1, size=16)
    with pytest.raises(ValueError):
        tc.radius_many([tdb.SearchArgs(vector=q, radius=0.5),
                        tdb.SearchArgs(vector=q, k=3)])  # kNN in the group
    with pytest.raises(ValueError):
        tc.radius_many([tdb.SearchArgs(vector=q, radius=0.5,
                                       precision="exact"),
                        tdb.SearchArgs(vector=q, radius=0.5)])
    with pytest.raises(ValueError):
        tc.radius_many([tdb.SearchArgs(vector=q, radius=0.5,
                                       filter=lambda i, md: True)])
    with pytest.raises(ValueError):  # a radius search in a kNN group
        tc.search_many([tdb.SearchArgs(vector=q, k=3),
                        tdb.SearchArgs(vector=q, k=3, radius=0.5)])
    assert tc.radius_many([]) == []
    tc.close()


@pytest.mark.parametrize("metric,bits", [(jdb.COSINE, 8), (jdb.EUCLIDEAN, 16),
                                         (jdb.COSINE, 4), (jdb.EUCLIDEAN, 64)])
def test_large_group_and_large_radius_run_the_k4_branch(
        tmp_path, device_paths, surface_calls, metric, bits):
    """72 queries bucket to 128, past the fused budget at kk = 1024, so the
    first dispatch selects over K4's surface; a radius holding more than
    1024 rows escalates kk to 4096, past the fused bound, too.  Both match
    the JAX package."""
    rng = np.random.default_rng(bits)
    dims = 15 if bits == 4 else 16
    vecs = rng.uniform(-1, 1, size=(3000, dims))
    jc, tc, _ = _pair(tmp_path, vecs=vecs, metric=metric, bits=bits)
    queries = rng.uniform(-1, 1, size=(72, dims))
    small = 0.3 if metric == jdb.COSINE else 1.2
    big = 0.48 if metric == jdb.COSINE else 3.2
    radii = [small] * 72
    radii[5] = big
    for precision in ("high", "exact"):
        before = surface_calls["surface"]
        jb = jc.radius_many([jdb.SearchArgs(vector=q, radius=r,
                                            precision=precision)
                             for q, r in zip(queries, radii)])
        tb = tc.radius_many([tdb.SearchArgs(vector=q, radius=r,
                                            precision=precision)
                             for q, r in zip(queries, radii)])
        assert surface_calls["surface"] > before
        assert len(tb[5].results) > 1024
        for q, a, b in zip(queries, jb, tb):
            _same(a, b, exact=precision == "exact", metric=metric, dims=dims,
                  scale=_scale(metric, q, vecs))
    # one query with the large radius: fused at kk = 1024 (margin >= 64),
    # then K4 at kk = 4096; the large-k dispatch leaves the hint unset
    calls = surface_calls["surface"]
    for precision in ("high", "exact"):
        a = jc.search(jdb.SearchArgs(vector=queries[5], radius=big,
                                     precision=precision))
        b = tc.search(tdb.SearchArgs(vector=queries[5], radius=big,
                                     precision=precision))
        _same(a, b, exact=precision == "exact", metric=metric, dims=dims,
              scale=_scale(metric, queries[5], vecs))
    assert (1024, 1) in surface_calls["fused"]
    assert surface_calls["surface"] >= calls + 2
    assert tc._seg_margin_hint is None
    jc.close()
    tc.close()


def test_filtered_radius_on_the_device_branch(tmp_path, device_paths):
    rng = np.random.default_rng(21)
    vecs = rng.uniform(-1, 1, size=(3000, 16))
    jc, tc, _ = _pair(tmp_path, vecs=vecs)
    queries = rng.uniform(-1, 1, size=(9, 16))
    for fq in ("i < 1500", "i >= 2990 OR i == 7"):
        for precision in ("high", "exact", "medium"):
            jb = jc.radius_many([jdb.SearchArgs(
                vector=q, radius=0.45, filter_query=fq, precision=precision)
                for q in queries])
            tb = tc.radius_many([tdb.SearchArgs(
                vector=q, radius=0.45, filter_query=fq, precision=precision)
                for q in queries])
            flt = tdb.build_filter(fq)
            for a, b in zip(jb, tb):
                assert all(flt(r.id, r.metadata) for r in b.results)
                if precision != "medium":
                    _same(a, b, exact=precision == "exact",
                          metric=jdb.COSINE, dims=16)
    jc.close()
    tc.close()


def test_radius_medium_escalates_past_budget(tmp_path, device_paths):
    """tests/test_collection.py's dense cone: the sketch budget escalates
    x4 until the in-radius set is complete, in both packages."""
    rng = np.random.default_rng(42)
    n, d = 2000, 8
    base = rng.normal(size=(d,))
    base /= np.linalg.norm(base)
    near = base[None, :] + 0.001 * rng.normal(size=(1500, d))
    far = rng.normal(size=(500, d)) + 5.0
    vecs = np.vstack([near, far])
    vecs = np.clip(vecs / np.abs(vecs).max(), -1, 1)
    jc, tc, _ = _pair(tmp_path, vecs=vecs, metric=jdb.COSINE, bits=32,
                      search_budget=256)
    exact = tc.search(tdb.SearchArgs(vector=vecs[0], radius=0.2,
                                     precision="exact"))
    assert len(exact.results) >= 1400
    _same(jc.search(jdb.SearchArgs(vector=vecs[0], radius=0.2,
                                   precision="exact")), exact, exact=True,
          metric=jdb.COSINE, dims=d)
    med = tc.search(tdb.SearchArgs(vector=vecs[0], radius=0.2,
                                   precision="medium"))
    jmed = jc.search(jdb.SearchArgs(vector=vecs[0], radius=0.2,
                                    precision="medium"))
    got = {r.id for r in med.results}
    want = {r.id for r in exact.results}
    assert len(med.results) > 256
    assert len(got & want) / len(want) >= \
        len({r.id for r in jmed.results} & want) / len(want) - 1e-9
    assert len(got & want) / len(want) > 0.98
    jc.close()
    tc.close()


def test_note_margin_ignores_large_k(tmp_path):
    """tests/test_provable_high.py's pin: large-k (radius) dispatches never
    write the serving-class margin hint."""
    _, tc, _ = _pair(tmp_path, n=20)
    assert tc._seg_margin_hint is None
    tc._note_margin(64, 1.0, kk=tscan.MAX_FUSED_K + 1)
    assert tc._seg_margin_hint is None        # large k: ignored
    tc._note_margin(64, 1e-4, kk=10)
    assert tc._seg_margin_hint is None        # outlier fraction: ignored
    tc._note_margin(64, 1.0, kk=10)
    assert tc._seg_margin_hint == 64          # structural serving-class
    tc._note_margin(8, 1.0, kk=10)
    assert tc._seg_margin_hint == 64          # monotone max
    tc.close()


def test_empty_collection_and_zero_results(tmp_path, device_paths):
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "e.dat"), dimension_count=4, quantization=8),
        device="cpu")
    assert c.search(tdb.SearchArgs(vector=[0.1] * 4, radius=0.5)).results \
        == []
    assert [r.results for r in c.radius_many(
        [tdb.SearchArgs(vector=[0.1] * 4, radius=0.5)] * 3)] == [[]] * 3
    c.add_document(1, [0.1, 0.2, 0.3, 0.4], b"{}")
    res = c.search(tdb.SearchArgs(vector=[-0.1, -0.2, -0.3, -0.4],
                                  radius=0.01, precision="high"))
    assert res.results == [] and res.percent_searched == 100.0
    c.close()


def _non_fused_working_sets(cap: int, dims: int, q: int):
    """(kk, row margin, bytes) of every dispatch the non-fused branch can
    make for a q-query radius group over cap rows: each rung of the kk x4
    escalation at each rung of the margin ladder (6 segments, then 64, 512,
    8192, then every row), its query chunks' selection plus one rerank
    piece."""
    kk = min(1024, cap)
    while True:
        for seg_margin in (6, 64, 512, 8192, 1 << 30):
            s = min(kk + seg_margin * tscan.DEFAULT_SEG, cap)
            chunk = tscan.surface_chunk(q, cap, s)
            piece = min(tscan.rerank_piece(chunk, dims), s)
            sorts = chunk <= tscan.TOPK_SORT_SLICES
            yield kk, s - kk, (
                chunk * tscan.surface_query_bytes(cap, s, sorts=sorts) +
                chunk * piece * (12 * dims + 32))
        if kk >= cap:
            return
        kk = min(kk * 4, cap)


def test_capacity_estimate_covers_a_1024_query_radius_group():
    """core/capacity.py budgets the non-fused K4 branch: for a 1024-query
    radius group over 1M rows of 384 dims (the group is past the fused
    budget from its first dispatch), every dispatch of the kk x4 and margin
    escalations runs query chunks whose surface, topk working set,
    selected candidates and rerank piece stay inside the estimate's search
    transient, up to every row; the first dispatch of a 128-query group
    runs in one chunk (one K4 launch)."""
    from syzgydb_tpu_torch.core import capacity

    cap, dims, q = 1 << 20, 384, 1024
    assert not tscan.fused_k_ok(1024, q)
    est = capacity.search_transient(cap)
    assert est["non_fused"] == tscan.SURFACE_BUDGET_BYTES
    for kk, margin, working in _non_fused_working_sets(cap, dims, q):
        assert working <= est["non_fused"], (kk, margin, working)
    assert tscan.surface_chunk(128, cap, 1024 + 6 * tscan.DEFAULT_SEG) == 128
    # the fused route's 2048-query segment-min surface is budgeted too
    assert est["fused"] >= 4 * 2048 * (cap // tscan.DEFAULT_SEG)
    assert est["peak"] == max(est["fused"], est["non_fused"])
    full = capacity.estimate(cap, dims, dims, 5, 16)
    assert full["device_peak"] == full["device_bytes"] + est["peak"]


def test_capacity_admits_20m_rows_of_384_dims_on_an_80gb_card(tmp_path):
    """The non-fused branch's budget does not crowd out the columns: a
    collection grown to 20M rows of 384 dims at 8 bits (this port's hash
    width and code layout) still places under 0.9 x 80 GB, and a single
    query escalating to every row stays within the branch's budget."""
    from syzgydb_tpu_torch.core import capacity

    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "c.dat"), dimension_count=384, quantization=8),
        device="cpu")
    cols = c.columns
    cap = capacity.grown_capacity(cols.capacity, 20_000_000)
    row = cols.codes.shape[1] * cols.codes.dtype.itemsize
    est = capacity.estimate(cap, row, row, cols.hash_words, 0)
    c.close()
    assert cap >= 20_000_000
    assert est["device_peak"] < 0.9 * 80e9, est
    assert capacity.search_transient(cap)["non_fused"] == \
        tscan.SURFACE_BUDGET_BYTES
    for kk, margin, working in _non_fused_working_sets(cap, 384, 1):
        assert working <= tscan.SURFACE_BUDGET_BYTES, (kk, margin, working)


@pytest.fixture
def noisy_k4(monkeypatch):
    """Kernel K4 at the edge of its error bound: the plain f32 surface plus
    a seeded uniform error of up to 0.9 x surface_delta on every finite
    entry, so the surface and the rerank's formula disagree by
    rounding-sized amounts at the kk-th row.  It stands in for
    _score_surface, which surface_topk calls (with the route's dq_rel,
    None on the CPU).  Counts its calls."""
    real = tscan._score_surface
    gen = torch.Generator().manual_seed(77)
    calls = [0]

    def noisy(queries, codes, norms, valid, *, bits, metric, exact=False):
        calls[0] += 1
        out, dq_rel = real(queries, codes, norms, valid, bits=bits,
                           metric=metric, exact=exact)
        delta = tscan.surface_delta(queries.square().sum(-1), norms, valid,
                                    metric=metric, dims=queries.shape[1],
                                    dq_rel=dq_rel, bits=bits)
        u = torch.rand(out.shape, generator=gen, dtype=torch.float64)
        noise = (0.9 * (2.0 * u - 1.0) * delta.double()[:, None])
        return torch.where(torch.isfinite(out), out + noise.to(out.dtype),
                           out), dq_rel

    monkeypatch.setattr(tscan, "_score_surface", noisy)
    return calls


def _near_tie_corpus(n, d, n_ties, seed):
    """Unit vectors far from the query e0, and a cluster of n_ties rows at
    cosines 0.7 + i * 1e-6 to it, scattered over the rows: consecutive
    ranks differ by 5e-7 in the cosine surrogate, well under K4's error
    bound (surface_delta, ~2e-5 at 16 dims) and well over f32 rounding.
    -> (vectors, the query, the f64 distances, rows nearest first)."""
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[:, 0] = np.abs(db[:, 0]) * 0.2
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    rows = rng.choice(n, n_ties, replace=False)
    cos = 0.7 + np.arange(n_ties) * 1e-6
    db[rows] = 0.0
    db[rows, 0] = cos
    db[rows, 1] = np.sqrt(1.0 - cos * cos)
    db = np.float32(db)
    q = np.zeros(d, dtype=np.float32)
    q[0] = 1.0
    d64 = np.arccos(np.clip(db.astype(np.float64) @ q, -1, 1)) / np.pi
    return db, q, d64, np.argsort(d64, kind="stable")


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_surface_topk_proves_its_cut_at_a_near_tie(noisy_k4, metric):
    """The kk-th row sits inside a cluster of near-ties that K4's error
    scrambles: the selection must not report a cut it cannot prove, and
    wherever its flag holds the rows are the true top-kk (the f64 order,
    which the near-tie spacing makes f32's too)."""
    from syzgydb_tpu_torch.ops import distance as tdist

    db, q, d64, order = _near_tie_corpus(4096, 16, 600, seed=5)
    _, codes, norms = tdist.ingest_reprs(db, 32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (q[None, :], codes, norms, np.ones(4096, dtype=bool))]
    kk = 300
    want = order[:kk]
    # no margin: the kk selected rows' largest surface value is within
    # 0.9 delta of their largest exact one, so the cut is never proven
    _, _, ok = tscan.surface_topk(*args, bits=32, metric=metric, k=kk,
                                  margin=0)
    assert ok.tolist() == [0]
    proven = None
    for margin in (64, 512, 4096):
        dist, rows, ok = tscan.surface_topk(*args, bits=32, metric=metric,
                                            k=kk, margin=margin)
        if int(ok[0]):
            assert rows[0].tolist() == want.tolist(), margin
            proven = margin
            break
    assert proven is not None
    assert noisy_k4[0] >= 2
    want_d = d64[want] if metric == "cosine" else \
        np.sqrt(2.0 - 2.0 * np.cos(np.pi * d64[want]))
    np.testing.assert_allclose(dist[0].numpy(), want_d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("precision", ["high", "exact"])
def test_radius_at_a_near_tie_on_the_k4_branch(tmp_path, device_paths,
                                               noisy_k4, precision):
    """A radius planted between two near-tied rows, just under the kk-th
    row of the first dispatch (kk = 1024) and, in a second group, past it:
    a 72-query group rides the non-fused K4 branch from its first dispatch,
    and every in-radius row comes back, none past the radius."""
    db, q, d64, order = _near_tie_corpus(8192, 16, 3000, seed=8)
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "t.dat"), distance_method=tdb.COSINE,
        dimension_count=16, quantization=32, create_and_overwrite=True),
        device="cpu")
    c.add_documents(list(range(len(db))), db, [b"{}"] * len(db))
    for r in (1021, 1500):
        radius = float((d64[order[r]] + d64[order[r + 1]]) / 2.0)
        calls = noisy_k4[0]
        res = c.radius_many([tdb.SearchArgs(vector=q, radius=radius,
                                            precision=precision)] * 72)
        assert noisy_k4[0] > calls
        want = set(order[:r + 1].tolist())
        for x in res:
            assert {y.id for y in x.results} == want
            assert all(y.distance <= radius for y in x.results)
    c.close()

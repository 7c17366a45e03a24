"""The port's Collection (syzgydb_tpu_torch) against the JAX package's on
identical inserts, on the CPU.

The JAX side runs its device path as tests/test_lean.py runs it:
pallas_scan.supported -> True and Collection._kernel_interpret -> True, so
its fused Pallas kernel runs in interpret mode.  HOST_SCAN_MAX_ELEMS is
patched to 0 in both packages so small collections take the device path
(the port's CPU tensors run the plain versions of its kernels).  Ids, order
and percent_searched must match for high and exact; distances agree to
f32 rounding (rtol 1e-5: both rerank in exact f32, in different summation
orders) for high and exactly for exact (both rerank on the host in f64).
High's distances are compared as surrogates — squared euclidean, or
(1 - cos)/2 — because acos amplifies an f32 cosine error ~1e-7 into
~1e-5 near distance 0 (rtol 1e-5, atol 2e-5 absorbs the f32 cancellation
of |q|^2 - 2 q.v + |v|^2 at near-duplicates)."""

import json

import numpy as np
import pytest
import torch

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.core import collection as jcoll
from syzgydb_tpu.ops import pallas_scan as jscan
from syzgydb_tpu_torch import convert
from syzgydb_tpu_torch.core import collection as tcoll

N, DIMS = 3000, 64


@pytest.fixture
def device_paths(monkeypatch):
    monkeypatch.setattr(jscan, "supported", lambda: True)
    monkeypatch.setattr(jdb.Collection, "_kernel_interpret", True)
    monkeypatch.setattr(jcoll, "HOST_SCAN_MAX_ELEMS", 0)
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    return monkeypatch


def _vectors(n=N, dims=DIMS, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, dims))
    v = centers[rng.integers(0, 32, n)] + 0.4 * rng.standard_normal((n, dims))
    v /= np.abs(v).max()
    v[11] = 0.0  # a zero vector
    return v


def _pair(tmp_path, metric, bits, vecs, **opts):
    out = []
    for pkg, name, kw in ((jdb, "jax.dat", {}),
                          (tdb, "port.dat", {"device": "cpu"})):
        c = pkg.Collection(pkg.CollectionOptions(
            name=str(tmp_path / name), distance_method=metric,
            dimension_count=vecs.shape[1], quantization=bits,
            create_and_overwrite=True, index_seed=11, **opts), **kw)
        ids = list(range(10, 10 + len(vecs)))
        c.add_documents(ids, vecs,
                        [json.dumps({"i": i}).encode() for i in ids])
        c.remove_document(13)
        out.append(c)
    return out


def _same(a, b, exact):
    assert [r.id for r in a.results] == [r.id for r in b.results]
    assert a.percent_searched == b.percent_searched
    assert [r.metadata for r in a.results] == [r.metadata for r in b.results]
    da = [r.distance for r in a.results]
    db = [r.distance for r in b.results]
    if exact:
        assert da == db
    else:
        np.testing.assert_allclose(_surrogate(db), _surrogate(da),
                                   rtol=1e-5, atol=2e-5)


def _surrogate(d):
    d = np.asarray(d, dtype=np.float64)
    return np.stack([d * d, (1.0 - np.cos(np.pi * d)) / 2.0])


CASES = [(jdb.COSINE, 8), (jdb.EUCLIDEAN, 8), (jdb.COSINE, 4),
         (jdb.EUCLIDEAN, 16), (jdb.COSINE, 64)]


@pytest.mark.parametrize("metric,bits", CASES)
def test_high_and_exact_match_jax(tmp_path, device_paths, metric, bits):
    vecs = _vectors()
    jc, tc = _pair(tmp_path, metric, bits, vecs)
    rng = np.random.default_rng(1)
    queries = vecs[rng.integers(0, N, 12)] + 0.05 * rng.standard_normal(
        (12, DIMS))
    for precision in ("high", "exact"):
        args = [tdb.SearchArgs(vector=q, k=10, precision=precision)
                for q in queries]
        jargs = [jdb.SearchArgs(vector=q, k=10, precision=precision)
                 for q in queries]
        for a, b in zip(jc.search_many(jargs), tc.search_many(args)):
            _same(a, b, precision == "exact")
        _same(jc.search(jargs[0]), tc.search(args[0]), precision == "exact")
    assert tc.sync_stats["full"] == 1
    jc.close()
    tc.close()


def _recall(results, truth):
    return np.mean([len({r.id for r in res.results} & t) / len(t)
                    for res, t in zip(results, truth)])


def test_medium_recall_no_worse_than_jax(tmp_path, device_paths):
    vecs = _vectors(seed=8)
    # a small budget keeps single queries below the scan crossover
    jc, tc = _pair(tmp_path, jdb.COSINE, 8, vecs, search_budget=96)
    rng = np.random.default_rng(2)
    queries = vecs[rng.integers(0, N, 24)] + 0.05 * rng.standard_normal(
        (24, DIMS))
    truth = [{r.id for r in jc.search(jdb.SearchArgs(
        vector=q, k=10, precision="exact")).results} for q in queries]
    jres = [jc.search(jdb.SearchArgs(vector=q, k=10)) for q in queries]
    tres = [tc.search(tdb.SearchArgs(vector=q, k=10)) for q in queries]
    assert all(r.percent_searched < 100.0 for r in tres)
    assert [r.percent_searched for r in tres] == \
        [r.percent_searched for r in jres]
    # identical sketches; the port's exact selection can only gain
    assert _recall(tres, truth) >= _recall(jres, truth) - 0.02
    assert _recall(tres, truth) >= 0.8
    jc.close()
    tc.close()


def test_callable_filter_matches_jax(tmp_path, device_paths):
    vecs = _vectors(seed=9)
    jc, tc = _pair(tmp_path, jdb.EUCLIDEAN, 8, vecs)

    def odd(doc_id, md):
        return doc_id % 2 == 1

    for precision in ("high", "exact"):
        a = jc.search(jdb.SearchArgs(vector=vecs[5], k=7, filter=odd,
                                     precision=precision))
        b = tc.search(tdb.SearchArgs(vector=vecs[5], k=7, filter=odd,
                                     precision=precision))
        assert all(r.id % 2 == 1 for r in b.results)
        _same(a, b, precision == "exact")
    jc.close()
    tc.close()


def test_scatter_sync_and_reopen_across_packages(tmp_path, device_paths):
    vecs = _vectors(seed=10)
    jc, tc = _pair(tmp_path, jdb.COSINE, 8, vecs)
    q = tdb.SearchArgs(vector=vecs[100], k=5, precision="high")
    tc.search(q)
    # small mutations after placement ride the in-place scatter
    tc.add_document(5000, vecs[100] * 0.999, b'{"new": 1}')
    tc.remove_document(110)
    jc.add_document(5000, vecs[100] * 0.999, b'{"new": 1}')
    jc.remove_document(110)
    got = tc.search(q)
    assert tc.sync_stats == {"full": 1, "scatter": 1}
    assert got.results[0].id == 5000
    assert 110 not in [r.id for r in got.results]
    _same(jc.search(jdb.SearchArgs(vector=vecs[100], k=5, precision="high")),
          got, False)
    path_t, path_j = tc.options.name, jc.options.name
    tc.close()
    jc.close()
    # each package reopens the other's file with the same documents
    tj = tdb.Collection(tdb.CollectionOptions(name=path_j), device="cpu")
    jt = jdb.Collection(jdb.CollectionOptions(name=path_t))
    assert tj.get_all_ids() == jt.get_all_ids()
    assert tj.options.index_seed == jt.options.index_seed == 11
    for a, b in ((jt, tj),):
        for precision in ("high", "exact"):
            _same(a.search(jdb.SearchArgs(vector=vecs[7], k=10,
                                          precision=precision)),
                  b.search(tdb.SearchArgs(vector=vecs[7], k=10,
                                          precision=precision)),
                  precision == "exact")
    tj.close()
    jt.close()


def test_device_state_from_jax_columns(tmp_path, device_paths):
    vecs = _vectors(seed=11)
    jc, tc = _pair(tmp_path, jdb.COSINE, 64, vecs)
    jdev = jc._device_state()
    state = convert.device_state_from_numpy(
        jc.columns.codes, jc.columns.norms, jc.columns.valid,
        np.asarray(jdev["hashes"]), bits=64, device="cpu")
    own = tc._device_state()
    for key in ("codes", "norms", "valid", "hashes"):
        assert state[key].dtype == own[key].dtype
        assert torch.equal(state[key], own[key]), key
    jc.close()
    tc.close()


def test_crud_list_mode_and_stats(tmp_path):
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "c.dat"), distance_method=tdb.EUCLIDEAN,
        dimension_count=4, quantization=16), device="cpu")
    for i in (2, 10, 1, 100):
        c.add_document(i, [0.1 * i % 1, 0.2, 0.3, 0.4], b'{"v": %d}' % i)
    c.update_document(10, b'{"v": "ten"}')
    assert c.get_document(10).metadata == b'{"v": "ten"}'
    np.testing.assert_allclose(c.get_document(2).vector,
                               [0.2, 0.2, 0.3, 0.4], atol=1e-4)
    res = c.search(tdb.SearchArgs(offset=1, limit=2))
    assert [r.id for r in res.results] == [10, 100]  # decimal-string order
    assert res.percent_searched == 75.0
    res = c.search(tdb.SearchArgs(filter=lambda i, md: i > 5))
    assert [r.id for r in res.results] == [10, 100]
    c.remove_document(100)
    with pytest.raises(KeyError):
        c.get_document(100)
    stats = c.compute_stats()
    assert stats.document_count == 3 and stats.quantization == 16
    assert stats.distance_method == "euclidean"
    # small collections answer on the host in f64
    hit = c.search(tdb.SearchArgs(vector=[0.1, 0.2, 0.3, 0.4], k=1,
                                  precision="high"))
    assert hit.results[0].id == 1 and hit.results[0].distance < 1e-4
    c.close()


def test_list_mode_sort_cached_per_generation(tmp_path):
    """tests/test_round3.py's case on both packages: repeated pagination
    does not re-sort, a mutation re-sorts once, and the pages agree."""
    ids = [3, 30, 7, 100, 25, 9]
    vecs = np.tile(np.arange(4, dtype=float), (len(ids), 1))
    pages = {}
    for pkg, kw in ((jdb, {}), (tdb, {"device": "cpu"})):
        c = pkg.Collection(pkg.CollectionOptions(
            name=str(tmp_path / f"{pkg.__name__}.dat"), dimension_count=4,
            quantization=8, distance_method=pkg.COSINE,
            create_and_overwrite=True, index_seed=7), **kw)
        c.add_documents(ids, vecs,
                        [json.dumps({"i": i}).encode() for i in ids])
        r1 = c.search(pkg.SearchArgs(offset=1, limit=2))
        sorts = c._list_sort_count
        assert sorts >= 1
        r2 = c.search(pkg.SearchArgs(offset=3, limit=2))
        r3 = c.search(pkg.SearchArgs())
        assert c._list_sort_count == sorts, "repeat pagination re-sorted"
        c.add_document(5, vecs[0], b"{}")  # a mutation invalidates
        r4 = c.search(pkg.SearchArgs())
        assert c._list_sort_count == sorts + 1
        c.search(pkg.SearchArgs(limit=3))
        assert c._list_sort_count == sorts + 1
        pages[pkg.__name__] = [[r.id for r in r.results]
                               for r in (r1, r2, r3, r4)]
        c.close()
    # lexicographic decimal-string order: 100, 25, 3, 30, 7, 9
    order = [100, 25, 3, 30, 7, 9]
    assert pages["syzgydb_tpu_torch"] == pages["syzgydb_tpu"] == [
        order[1:3], order[3:5], order, [100, 25, 3, 30, 5, 7, 9]]


def _tie_corpus():
    """tests/test_provable_high.py's adversarial corpus (300 segments whose
    minima differ at the 1e-6 level; the true winners sit at the highest
    segment indices)."""
    n, d, n_ties, lo = 65536, 16, 300, 600
    rng = np.random.default_rng(9)
    db = rng.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[:, 0] = np.abs(db[:, 0]) * 0.2
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    for i in range(n_ties):
        row = (lo + i) * 32
        cos = 0.7 + i * 1e-6
        db[row] = 0.0
        db[row, 0] = cos
        db[row, 1] = np.sqrt(1.0 - cos * cos)
    q = np.zeros(d)
    q[0] = 1.0
    want = [(lo + n_ties - 1 - i) * 32 for i in range(10)]
    return db, q, want


def test_escalation_on_tie_corpus_matches_jax(tmp_path, device_paths):
    db, q, want = _tie_corpus()
    out = []
    for pkg, name, kw in ((jdb, "jax.dat", {}),
                          (tdb, "port.dat", {"device": "cpu"})):
        c = pkg.Collection(pkg.CollectionOptions(
            name=str(tmp_path / name), distance_method=pkg.COSINE,
            dimension_count=16, quantization=32, index_seed=3), **kw)
        c.add_documents(list(range(len(db))), db, [b""] * len(db))
        res = c.search(pkg.SearchArgs(vector=q, k=10, precision="high"))
        out.append(res)
        assert [r.id for r in res.results] == want
        c.close()
    _same(out[0], out[1], False)

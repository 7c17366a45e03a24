"""Escalation rounds of a high kNN batch (Collection._knn_many_async's
finish): a round re-dispatches only the batch's queries whose completeness
flag is 0, and the others keep their first answers, which the flag proved.

On the CPU (the kernels' plain versions, HOST_SCAN_MAX_ELEMS patched to 0
in both packages, as tests/test_torch_collection.py does) a batch of
ordinary queries with the tie corpus's query among them answers every query
as it is answered alone and as the JAX package answers the batch;
spans.escalate_q counts the failing queries a round re-dispatches; a write
between dispatch and finish() sends the whole batch again, so that its
answers come from the new state alone; and a batch in which every query
fails goes whole, as before.  On the card (marked cuda) a 1,024-query
batch with a few forced failures gives the ids of the whole batch sent up
the margin ladder, through the fp32 tile loop (16-bit codes) and the int8
route (8-bit codes)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import syzgydb_tpu_torch as tdb
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.parallel import mesh as tmesh
from syzgydb_tpu_torch.utils import spans

K = 10
TIE_AT = 3  # the tie corpus's query's place in the batch
CASES = [(tdb.COSINE, 32), (tdb.COSINE, 8), (tdb.EUCLIDEAN, 16)]


# The JAX package and tests/test_torch_collection.py (which imports it) are
# imported by the CPU tests alone: the card has no JAX, and collects this
# module for its cuda test.

@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)


@pytest.fixture
def jdb(monkeypatch, device_path):
    """The JAX package on its device path, as test_torch_collection.py's
    device_paths sets it."""
    import syzgydb_tpu as jdb
    from syzgydb_tpu.core import collection as jcoll
    from syzgydb_tpu.ops import pallas_scan as jscan
    monkeypatch.setattr(jscan, "supported", lambda: True)
    monkeypatch.setattr(jdb.Collection, "_kernel_interpret", True)
    monkeypatch.setattr(jcoll, "HOST_SCAN_MAX_ELEMS", 0)
    return jdb


def _tie_corpus():
    from test_torch_collection import _tie_corpus
    return _tie_corpus()


def _same(a, b, exact):
    from test_torch_collection import _same
    _same(a, b, exact)


def _batch(db, q, n=8, seed=5):
    """n queries near corpus rows, the tie query at TIE_AT."""
    rng = np.random.default_rng(seed)
    qs = db[rng.integers(0, len(db), n)] + \
        0.05 * rng.standard_normal((n, db.shape[1]))
    qs[TIE_AT] = q
    return qs


def _open(pkg, path, metric, bits, db, **kw):
    c = pkg.Collection(pkg.CollectionOptions(
        name=str(path), distance_method=metric, dimension_count=db.shape[1],
        quantization=bits, create_and_overwrite=True, index_seed=3), **kw)
    c.add_documents(list(range(len(db))), db, [b""] * len(db))
    return c


def _port(tmp_path, metric, bits, db, name="port.dat"):
    return _open(tdb, tmp_path / name, metric, bits, db, device="cpu")


def _high(pkg, qs):
    return [pkg.SearchArgs(vector=v, k=K, precision="high") for v in qs]


def _traced(fn):
    """fn() under a profiler -> (its result, escalate_n, escalate_q)."""
    n0, q0 = spans.escalate_n, spans.escalate_q
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, spans.escalate_n - n0, spans.escalate_q - q0


@pytest.fixture
def sizes(monkeypatch):
    """The query count of every device dispatch, in order."""
    seen = []
    orig = tcoll.Collection._exact_topk_device

    def spy(self, queries, *a, **kw):
        seen.append(queries.shape[0])
        return orig(self, queries, *a, **kw)
    monkeypatch.setattr(tcoll.Collection, "_exact_topk_device", spy)
    return seen


@pytest.mark.parametrize("metric,bits", CASES)
def test_batch_answers_as_alone_and_as_jax(tmp_path, jdb, sizes, metric,
                                           bits):
    db, q, want = _tie_corpus()
    qs = _batch(db, q)
    jc = _open(jdb, tmp_path / "jax.dat", metric, bits, db)
    tc = _port(tmp_path, metric, bits, db)
    try:
        got, rounds, requeued = _traced(lambda: tc.search_many(_high(tdb, qs)))
        # the first dispatch takes the batch, every round the tie query
        assert rounds >= 1 and sizes == [len(qs)] + [1] * rounds
        assert requeued == rounds
        if bits == 32:  # narrower codes round the tie cluster's steps
            assert [r.id for r in got[TIE_AT].results] == want
        alone = [tc.search(a) for a in _high(tdb, qs)]
        ref = jc.search_many(_high(jdb, qs))
    finally:
        jc.close()
        tc.close()
    for g, a, r in zip(got, alone, ref):
        _same(a, g, True)
        _same(r, g, False)


@pytest.mark.parametrize("bits", [32, 8])
def test_escalate_q_counts_the_failing_queries(tmp_path, device_path, bits):
    db, q, _ = _tie_corpus()
    qs = _batch(db, q, n=16)
    qs[11] = q  # two failing queries of sixteen
    c = _port(tmp_path, tdb.COSINE, bits, db)
    try:
        _, rounds, requeued = _traced(lambda: c.search_many(_high(tdb, qs)))
    finally:
        c.close()
    assert rounds >= 1
    assert requeued == 2 * rounds


def test_write_before_finish_requeues_the_whole_batch(tmp_path, device_path,
                                                      sizes):
    db, q, want = _tie_corpus()
    qs = _batch(db, q)
    c = _port(tmp_path, tdb.COSINE, 32, db)
    try:
        fin = c.search_many_async(_high(tdb, qs))
        # a document at query 0's own place: only a dispatch on the new
        # state finds it
        c.add_documents([len(db)], qs[:1], [b"new"])
        got, rounds, requeued = _traced(fin)
        fresh = c.search_many(_high(tdb, qs))
    finally:
        c.close()
    # the first round goes whole on the new state, later ones take the
    # tie query alone
    assert rounds >= 1 and sizes[:2] == [len(qs), len(qs)]
    assert sizes[2:2 + rounds - 1] == [1] * (rounds - 1)
    assert requeued == len(qs) + rounds - 1
    assert got[0].results[0].id == len(db)
    assert [r.id for r in got[TIE_AT].results] == want
    for g, f in zip(got, fresh):
        _same(f, g, True)


def test_every_query_failing_goes_whole(tmp_path, jdb, sizes):
    db, q, want = _tie_corpus()
    qs = np.repeat(q[None, :], 8, axis=0)
    jc = _open(jdb, tmp_path / "jax.dat", tdb.COSINE, 32, db)
    tc = _port(tmp_path, tdb.COSINE, 32, db)
    try:
        got, rounds, requeued = _traced(lambda: tc.search_many(_high(tdb, qs)))
        ref = jc.search_many(_high(jdb, qs))
    finally:
        jc.close()
        tc.close()
    assert rounds >= 1 and sizes == [8] * (rounds + 1)
    assert requeued == 8 * rounds
    for g, r in zip(got, ref):
        assert [x.id for x in g.results] == want
        _same(r, g, False)


def test_mesh_requeues_the_failing_queries(tmp_path, device_path, sizes):
    """Under a mesh (four CPU shards) the rounds take the tie query alone,
    and the batch answers as on one device."""
    db, q, want = _tie_corpus()
    qs = _batch(db, q)
    c = _port(tmp_path, tdb.COSINE, 32, db)
    try:
        one = c.search_many(_high(tdb, qs))
        c.use_mesh(tmesh.make_mesh(tmesh.MeshConfig(data=4),
                                   [torch.device("cpu")] * 4))
        del sizes[:]
        got, rounds, requeued = _traced(lambda: c.search_many(_high(tdb, qs)))
    finally:
        c.close()
    assert rounds >= 1 and sizes == [len(qs)] + [1] * rounds
    assert requeued == rounds
    assert [r.id for r in got[TIE_AT].results] == want
    for g, o in zip(got, one):
        _same(o, g, False)


def _wide_tie_corpus(d, n=65536, n_ties=300, lo=600):
    """_tie_corpus at d dimensions: 300 segments whose minima differ at the
    1e-6 level, under either metric (the rows are unit vectors)."""
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
    return db, q


@pytest.mark.cuda
@pytest.mark.parametrize("metric,bits,dims", [(tdb.EUCLIDEAN, 16, 960),
                                               (tdb.COSINE, 8, 384)])
def test_cuda_requeued_batch_matches_the_whole_batch(tmp_path, monkeypatch,
                                                     sizes, metric, bits,
                                                     dims):
    """1,024 queries, three of them the tie query: the rounds re-dispatch
    the failing queries alone, and every query's ids equal, bit for bit,
    those of the whole batch sent up the margin ladder (64, 512, ...) until
    every flag is 1, as each round did before.  Distances agree as two f32
    reranks in different summation orders do (the batch's shape picks the
    contraction's order): surrogates within test_torch_collection.py's
    _same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    db, q = _wide_tie_corpus(dims)
    rng = np.random.default_rng(1024)
    qs = db[rng.integers(0, len(db), 1024)] + \
        0.05 * rng.standard_normal((1024, dims)) / np.sqrt(dims)
    qs[[5, 500, 1000]] = q
    c = _open(tdb, tmp_path / "card.dat", metric, bits, db, device="cuda")
    try:
        tm = c._seg_margin_hint
        got, rounds, requeued = _traced(lambda: c.search_many(_high(tdb, qs)))
        with c._lock:
            dev = c._device_state()
            queries = c._queries(qs)
            dist, rows, ties, su, ns = c._exact_topk_device(
                queries, dev, dev["valid"], K, tie_margin=tm)
            fail0 = int((ties == 0).sum())
            while int(ties.min()) == 0 and su < ns:
                tm = c._escalate_margin(tm)
                dist, rows, ties, su, ns = c._exact_topk_device(
                    queries, dev, dev["valid"], K, tie_margin=tm)
        ids = c.columns.ids
        want_ids = [[ids.item(int(r)) for r in rw] for rw in rows.cpu()]
        want_d = dist.float().cpu().numpy()
    finally:
        c.close()
    assert rounds >= 1 and 3 <= fail0 < 1024
    assert sizes[0] == 1024 and sizes[1] == fail0
    assert max(sizes[1:1 + rounds]) < 1024
    assert requeued == sum(sizes[1:1 + rounds])
    assert [[r.id for r in g.results] for g in got] == want_ids
    got_d = np.array([[r.distance for r in g.results] for g in got],
                     dtype=np.float64)
    want_d = np.float64(want_d)
    if metric == tdb.EUCLIDEAN:
        surr = np.square
    else:
        def surr(d):
            return (1.0 - np.cos(np.pi * d)) / 2.0
    np.testing.assert_allclose(surr(got_d), surr(want_d), rtol=1e-5,
                               atol=2e-5)

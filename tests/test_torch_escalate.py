"""Escalation rounds of the margin ladder (Collection._proven_topk), which
every exhaustive finish runs: high and exact kNN, high and exact radius.  A
round re-dispatches only the batch's queries whose completeness flag is 0,
and the others keep their first answers, which the flag proved.

On the CPU (the kernels' plain versions, HOST_SCAN_MAX_ELEMS patched to 0
in both packages, as tests/test_torch_collection.py does) a batch of
ordinary queries with the tie corpus's query among them answers every query
as it is answered alone and as the JAX package answers the batch, through
search_many at high and exact and radius_many at high; each round takes
the queries the last fetch left failing, and spans.escalate_q counts them;
a write between dispatch and finish() sends the whole batch again, so that
its answers come from the new state alone; and a batch in which every
query fails goes whole.  On the card (marked cuda) a 1,024-query batch
with a few forced failures gives the ids of the whole batch sent up the
margin ladder, through the fp32 tile loop (16-bit codes) and the int8
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


def _radius(pkg, qs):
    return [pkg.SearchArgs(vector=v, radius=RADIUS, precision="high")
            for v in qs]


def _exact(pkg, qs):
    return [pkg.SearchArgs(vector=v, k=K, precision="exact") for v in qs]


# Each way into the margin ladder: (its batch call, its searches, the tie
# corpus's shape for it).  The tie cluster must hold the search's last
# shortlisted rank: k for high kNN; k + 64 for exact kNN, whose top k
# (N_TOP nearer rows) stand clear of the cluster by more than the f64
# rerank's cushion; 1,024 for radius, whose RADIUS keeps the N_TOP rows
# and none of the cluster.
N_TOP, RADIUS = K, 0.2
ENTRIES = {
    "search_many": ("search_many", _high, {}),
    "radius_many": ("radius_many", _radius, {"n_ties": 1100, "n_top": N_TOP}),
    "exact": ("search_many", _exact, {"n_top": N_TOP}),
}


def _entry_corpus(entry):
    """(rows, tie query, the tie query's ids at 32 bits) for an entry."""
    shape = ENTRIES[entry][2]
    if not shape:
        return _tie_corpus()
    db, q = _wide_tie_corpus(16, **shape)
    return db, q, [(600 - 1 - j) * 32 for j in range(N_TOP)]


def _call(entry, pkg, c, qs):
    many, searches, _ = ENTRIES[entry]
    return getattr(c, many)(searches(pkg, qs))


@pytest.fixture
def flags(monkeypatch):
    """A copy of the completeness flags of every fetch, in order."""
    seen = []
    orig = tcoll.Collection._fetch_results

    def spy(dist, rows, counts=None, *, call):
        got = orig(dist, rows, counts, call=call)
        seen.append(None if got[2] is None else got[2].copy())
        return got
    monkeypatch.setattr(tcoll.Collection, "_fetch_results",
                        staticmethod(spy))
    return seen


def _failing(flags) -> list:
    """The failing query count of each fetch."""
    return [int((f == 0).sum()) for f in flags]


def _as_alone_and_as_jax(entry, jdb, tc, jc, qs, got):
    """The batch's answers equal each query's alone, bit for bit, and the
    JAX package's answers to the batch."""
    alone = [tc.search(a) for a in ENTRIES[entry][1](tdb, qs)]
    ref = _call(entry, jdb, jc, qs)
    for g, a, r in zip(got, alone, ref):
        _same(a, g, True)
        _same(r, g, False)


ROUND_CASES = [pytest.param("search_many", 32, id="32"),
               pytest.param("search_many", 8, id="8")] + [
    pytest.param(e, b, id=f"{e}-{b}") for e in ("radius_many", "exact")
    for b in (32, 8)]


@pytest.mark.parametrize("entry,bits", ROUND_CASES)
def test_escalate_q_counts_the_failing_queries(tmp_path, jdb, sizes, flags,
                                               entry, bits):
    """Each round of the margin ladder re-dispatches exactly the queries
    whose flag the last fetch left at 0 (two tie queries of sixteen, and
    any ordinary query the cluster reaches)."""
    db, q, want = _entry_corpus(entry)
    qs = _batch(db, q, n=16)
    qs[11] = q
    jc = _open(jdb, tmp_path / "jax.dat", tdb.COSINE, bits, db)
    tc = _port(tmp_path, tdb.COSINE, bits, db)
    try:
        got, rounds, requeued = _traced(lambda: _call(entry, tdb, tc, qs))
        fails = _failing(flags)
        assert {TIE_AT, 11} <= set(np.flatnonzero(flags[0] == 0).tolist())
        # each round takes the queries the last fetch left failing
        assert len(sizes) >= 2 and sizes[0] == len(qs)
        assert sizes[1:] == fails[:-1] and fails[-1] == 0
        assert max(sizes[1:]) < len(qs)
        assert rounds == len(sizes) - 1 and requeued == sum(sizes[1:])
        if entry == "search_many":  # at k = 10 the cluster reaches no other
            assert requeued == 2 * rounds
        if bits == 32:
            assert [r.id for r in got[TIE_AT].results] == want
        _as_alone_and_as_jax(entry, jdb, tc, jc, qs, got)
    finally:
        jc.close()
        tc.close()


@pytest.mark.parametrize("entry", ["search_many", "radius_many"])
def test_write_before_finish_requeues_the_whole_batch(tmp_path, jdb, sizes,
                                                      flags, monkeypatch,
                                                      entry):
    """A document written at the first fetch, between the batch's dispatch
    and its finish: the first round goes whole on the new state, later
    ones take the failing queries.  (precision="exact" runs under the
    lock, so no write can come between its rounds.)"""
    db, q, want = _entry_corpus(entry)
    qs = _batch(db, q)
    tc = _port(tmp_path, tdb.COSINE, 32, db)
    orig = tcoll.Collection._fetch_results
    written = []

    def write_first(dist, rows, counts=None, *, call):
        if not written:
            # a document at query 0's own place: only a dispatch on the
            # new state finds it
            written.append(len(db))
            tc.add_documents([len(db)], qs[:1], [b"new"])
        return orig(dist, rows, counts, call=call)
    try:
        with monkeypatch.context() as m:
            m.setattr(tcoll.Collection, "_fetch_results",
                      staticmethod(write_first))
            got, rounds, requeued = _traced(lambda: _call(entry, tdb, tc, qs))
        fails = _failing(flags)
        fresh = _call(entry, tdb, tc, qs)
        assert written and rounds >= 1
        assert sizes[:2] == [len(qs), len(qs)]
        assert sizes[2:rounds + 1] == fails[1:rounds] and fails[rounds] == 0
        assert max(sizes[2:rounds + 1], default=0) < len(qs)
        assert requeued == sum(sizes[1:rounds + 1])
        assert got[0].results[0].id == len(db)
        assert [r.id for r in got[TIE_AT].results] == want
        for g, f in zip(got, fresh):
            _same(f, g, True)
        jc = _open(jdb, tmp_path / "jax.dat", tdb.COSINE, 32, db)
        try:
            jc.add_documents([len(db)], qs[:1], [b"new"])
            _as_alone_and_as_jax(entry, jdb, tc, jc, qs, got)
        finally:
            jc.close()
    finally:
        tc.close()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_query_failing_goes_whole(tmp_path, jdb, sizes, entry):
    db, q, want = _entry_corpus(entry)
    qs = np.repeat(q[None, :], 8, axis=0)
    jc = _open(jdb, tmp_path / "jax.dat", tdb.COSINE, 32, db)
    tc = _port(tmp_path, tdb.COSINE, 32, db)
    try:
        got, rounds, requeued = _traced(lambda: _call(entry, tdb, tc, qs))
        assert rounds >= 1 and sizes == [8] * (rounds + 1)
        assert requeued == 8 * rounds
        for g in got:
            assert [x.id for x in g.results] == want
        _as_alone_and_as_jax(entry, jdb, tc, jc, qs, got)
    finally:
        jc.close()
        tc.close()


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


def _wide_tie_corpus(d, n=65536, n_ties=300, lo=600, n_top=0):
    """_tie_corpus at d dimensions: n_ties segments whose minima differ at
    the 1e-6 level, under either metric (the rows are unit vectors), and
    n_top rows nearer the query, 1e-3 apart, in the segments below them."""
    rng = np.random.default_rng(9)
    db = rng.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[:, 0] = np.abs(db[:, 0]) * 0.2
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    cosines = [(lo + i, 0.7 + i * 1e-6) for i in range(n_ties)] + \
        [(lo - 1 - j, 0.9 - j * 1e-3) for j in range(n_top)]
    for seg, cos in cosines:
        row = seg * 32
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

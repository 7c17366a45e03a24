"""Filtered exact search, the shape of the benchmark's 99% filter cell
(VectorDBBench Performance768D1M99P: 8-bit cosine codes, one predicate
`i >= int(rows x 0.99)` that 1% of the rows pass), on the CPU.

portbench/reference/filtered.py (plain PyTorch) against a brute-force
numpy float64 top-k over the passing rows; search_many with the shared
filter_query on the device path (HOST_SCAN_MAX_ELEMS patched to 0, so the
kernels run their plain versions on CPU tensors) against that reference
by the filtered caller's own check and the traffic's limits, filter_bad
included; the check catching a row that fails the predicate and a
dropped neighbour; the "filter" span counting one per filtered dispatch
and round; and ops/scan.pairs_scored counting Q x N a launch.  The `cuda`
case makes the same comparison on the card."""

import json
import math
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import syzgydb_tpu_torch as tdb
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.ops import scan
from syzgydb_tpu_torch.utils import spans
from portbench import compare, corpus, harness
from portbench.callers import filtered_search_many as caller
from portbench.reference import filtered
from portbench.reference.exact import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, K = 4096, 48, 10
GEN = {"centers": 64, "spread": 0.35, "seed": 1000768}


def _traffic(rows: int) -> dict:
    """The cell's traffic with its predicate cut to the same 1% of `rows`."""
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "filter99-high-b1024.json")) as f:
        tr = json.load(f)
    tr["filter"]["value"] = int(rows * 0.99)
    return tr


@pytest.fixture(scope="module", params=[64, 768])
def data(request):
    """(rows (N, D) f32, queries (Q, D) f64, 8-bit cosine reference)."""
    rows, gen = corpus.make_rows(GEN, N, request.param, torch.device("cpu"))
    queries = corpus.make_queries(rows, gen, Q, 0.2).double().numpy()
    return rows, queries, Reference(rows, bits=8, metric="cosine")


def _cell(ref, queries, traffic):
    return types.SimpleNamespace(ref=ref, pool=queries, traffic=traffic,
                                 device=torch.device("cpu"))


def _collection(path, rows, device="cpu"):
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(path), distance_method=tdb.COSINE,
        dimension_count=rows.shape[1], quantization=8), device=device)
    ids = list(range(rows.shape[0]))
    c.add_documents(ids, rows.numpy(), [compare.meta_of(i) for i in ids])
    return c


def _search(coll, queries, traffic):
    args = [tdb.SearchArgs(vector=q, k=traffic["k"],
                           precision=traffic["precision"],
                           filter_query=caller.filter_query(
                               traffic["filter"])) for q in queries]
    return compare.from_results(coll.search_many(args))


def test_predicate_and_query_string():
    tr = _traffic(N)
    rows = filtered.passing(tr["filter"], N)
    assert rows.tolist() == list(range(4055, N))
    assert caller.filter_query(tr["filter"]) == "i >= 4055"
    assert filtered.passing({"field": "j", "op": ">=", "value": 0},
                            10).size == 0
    with pytest.raises(ValueError):
        filtered.passing({"field": "i", "op": "~", "value": 0}, 10)


def test_reference_agrees_with_brute_force(data):
    """The filtered reference's ids and float64 distances are a numpy
    brute force's over the passing rows' decoded codes."""
    _, queries, ref = data
    passing = filtered.passing(_traffic(N)["filter"], N)
    dist, ids = filtered.FilteredReference(ref, passing).topk(
        queries, K, torch.device("cpu"))
    vecs = ref.stored(passing.copy()).numpy()
    dots = queries @ vecs.T
    den = np.linalg.norm(queries, axis=1)[:, None] * \
        np.linalg.norm(vecs, axis=1)[None, :]
    brute = np.arccos(np.clip(dots / den, -1.0, 1.0)) / math.pi
    for i in range(Q):
        order = np.lexsort((passing, brute[i]))[:K]
        assert ids[i].tolist() == passing[order].tolist()
        np.testing.assert_allclose(dist[i].numpy(), brute[i][order],
                                   rtol=0, atol=1e-12)


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)


def test_search_many_is_held_to_the_reference(data, tmp_path, device_path):
    """The port's filtered search_many on the device route passes every
    limit of the cell's traffic against reference/filtered.py."""
    rows, queries, ref = data
    tr = _traffic(N)
    c = _collection(tmp_path / "f.dat", rows)
    try:
        assert not c._small()
        answers = _search(c, queries, tr)
        stored = compare.stored_bad(ref, c.get_document, np.arange(0, N, 7))
    finally:
        c.close()
    cell = _cell(ref, queries, tr)
    nums = caller.check(None, cell, [(np.arange(Q), answers)])
    nums.update(stored_bad=stored, failed=0)
    checks = harness.judge(nums, tr["limits"])
    assert all(x["ok"] for x in checks.values()), checks
    assert set(nums) == set(tr["limits"])
    passing = set(filtered.passing(tr["filter"], N).tolist())
    assert all(set(a.ids.tolist()) <= passing and len(a.ids) == K
               for a in answers)


def _reference_answers(fref, queries, m):
    d, r = fref.topk(queries, m, torch.device("cpu"))
    return [compare.Answer(r[i].numpy().copy(), d[i].numpy().copy(),
                           [compare.meta_of(int(x)) for x in r[i]])
            for i in range(len(r))]


def test_check_catches_a_failing_row_and_a_dropped_neighbour(data):
    _, queries, ref = data
    tr = _traffic(N)
    cell = _cell(ref, queries, tr)
    fref = caller.reference(cell)
    idx = np.arange(Q)
    sound = _reference_answers(fref, queries, K)
    nums = caller.check(None, cell, [(idx, sound)])
    assert nums["filter_bad"] == 0 and nums["rank_gap"] == 0.0

    # one returned id swapped for a row that fails the predicate
    bad = _reference_answers(fref, queries, K)
    bad[3].ids[4] = 7
    bad[3].metas[4] = compare.meta_of(7)
    nums = caller.check(None, cell, [(idx, bad)])
    assert nums["filter_bad"] == 1

    # the nearest passing row dropped, the (K+1)-th in its place
    wide = _reference_answers(fref, queries, K + 1)
    dropped = [compare.Answer(a.ids[1:], a.dists[1:], a.metas[1:])
               for a in wide]
    nums = caller.check(None, cell, [(idx, dropped)])
    assert nums["filter_bad"] == 0 and nums["rank_gap"] > 1e-5


def test_setup_builds_only_the_searches(data, monkeypatch):
    """The caller's setup, timed in setup_s, makes the searches and no
    part of the reference; check builds the reference after the window."""
    _, queries, ref = data
    cell = _cell(ref, queries, _traffic(N))

    def no_reference(*a):
        raise AssertionError("setup built the reference")
    monkeypatch.setattr(caller, "reference", no_reference)
    monkeypatch.setattr(filtered, "passing", no_reference)
    args = caller.setup(cell)
    assert len(args) == Q
    assert {a.filter_query for a in args} == {f"i >= {int(N * 0.99)}"}
    assert all(a.k == K and a.precision == "high" for a in args)


def _spans_now() -> dict:
    return {n: getattr(spans, n) for n in (
        "filter_n", "filter_ns", "dispatch_n", "escalate_n")}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _spans_now().items()}


def test_filter_span_counts_dispatches_and_rounds(tmp_path, device_path):
    """Under a profiler the filter span fires once per filtered dispatch
    and once per filtered escalation round, and never for an unfiltered
    search; off, it counts nothing."""
    # imported here: test_torch_collection imports the JAX package, which
    # the card's `-m cuda --noconftest` run of this file does without
    from test_torch_collection import _tie_corpus

    db, q, want = _tie_corpus()
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "tie.dat"), distance_method=tdb.COSINE,
        dimension_count=16, quantization=32, index_seed=3), device="cpu")
    ids = list(range(len(db)))
    c.add_documents(ids, db, [compare.meta_of(i) for i in ids])
    # every one of the corpus's 300 tied segments passes (rows 600 * 32
    # on), so the flag climbs the ladder as it does unfiltered
    filt = tdb.SearchArgs(vector=q, k=10, precision="high",
                          filter_query="i >= 19200")
    plain = tdb.SearchArgs(vector=q, k=10, precision="high")
    try:
        before = _spans_now()
        c.search_many([filt])
        assert _delta(before) == {k: 0 for k in before}
        c._seg_margin_hint = None
        before = _spans_now()
        with profile(activities=[ProfilerActivity.CPU]):
            got = c.search_many([filt])
        d = _delta(before)
        assert [r.id for r in got[0].results] == want
        assert d["escalate_n"] >= 1
        assert d["filter_n"] == d["dispatch_n"] + d["escalate_n"]
        assert d["filter_ns"] > 0
        before = _spans_now()
        with profile(activities=[ProfilerActivity.CPU]):
            c.search_many([plain] * 3)
            c.radius_many([tdb.SearchArgs(vector=q, radius=0.3,
                                          precision="high")])
        d = _delta(before)
        assert d["dispatch_n"] == 2
        assert d["filter_n"] == d["filter_ns"] == 0
    finally:
        c.close()


@pytest.mark.parametrize("how", ["fused", "segmin16", "surface", "topk"])
def test_pairs_scored_counts_each_launch(how):
    """Q x N per scan on the plain route, which counts no launch, whatever
    the rows' validity; the non-fused top-k's query chunks add up to Q."""
    rng = np.random.default_rng(5)
    n, d, q = 2048, 32, 9
    from syzgydb_tpu_torch.ops import distance as tdist
    db = rng.standard_normal((n, d))
    _, codes, norms = tdist.ingest_reprs(db, 8)
    tq = torch.from_numpy(np.float32(db[:q] + 0.1))
    tc, tn = torch.from_numpy(codes), torch.from_numpy(norms)
    tv = torch.from_numpy(rng.random(n) < 0.01)
    kw = dict(bits=8, metric="cosine")
    before = (scan.pairs_scored, scan.launches, scan.free_seg_launches,
              scan.surface_launches)
    if how == "fused":
        scan.fused_scan_topk(tq, tc, tn, tv, k=5, with_ties=True, **kw)
    elif how == "segmin16":
        scan.segment_min_scan(tq, tc, tn, tv, seg=16, **kw)
    elif how == "surface":
        scan.score_surface(tq, tc, tn, tv, exact=True, **kw)
    else:
        scan.surface_topk(tq, tc, tn, tv, k=5, margin=64, **kw,
                          budget_bytes=200_000)
    assert (scan.launches, scan.free_seg_launches,
            scan.surface_launches) == before[1:]
    assert scan.surface_chunk(q, n, 5 + 64, 200_000) < q
    assert scan.pairs_scored - before[0] == q * n


@pytest.mark.cuda
def test_search_many_on_the_card_is_held_to_the_reference(tmp_path):
    """The same comparison on the card: K1's int8 resident kernel at
    D = 768 over rows 99% of which the filter drops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 16384
    rows, gen = corpus.make_rows(GEN, n, 768, torch.device("cpu"))
    queries = corpus.make_queries(rows, gen, 256, 0.2).double().numpy()
    ref = Reference(rows, bits=8, metric="cosine")
    tr = _traffic(n)
    c = _collection(tmp_path / "f.dat", rows, device="cuda")
    try:
        assert not c._small()
        before = scan.i8_launches
        answers = _search(c, queries, tr)
        assert scan.i8_launches > before
    finally:
        c.close()
    cell = types.SimpleNamespace(ref=ref, pool=queries, traffic=tr,
                                 device=torch.device("cuda"))
    nums = caller.check(None, cell, [(np.arange(len(queries)), answers)])
    nums.update(stored_bad=0, failed=0)
    checks = harness.judge(nums, tr["limits"])
    assert all(x["ok"] for x in checks.values()), checks

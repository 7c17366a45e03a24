"""The port's search-path spans (syzgydb_tpu_torch/utils/spans.py) on the
CPU, with the kernels' plain versions.

HOST_SCAN_MAX_ELEMS is patched to 0 so that small collections take the
device path (as tests/test_torch_collection.py does).  Off, with no
profiler recording, a search touches no counter and enters no profiler
range; on, under torch.profiler, each search fires its dispatch, fetch,
escalate and results spans once per stage, with one call identifier, and
a filtered one its filter span in the dispatch and in each round."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import syzgydb_tpu_torch as tdb
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.utils import spans

from test_torch_collection import _tie_corpus

N, DIMS = 3000, 64


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)


def _counters() -> dict:
    return {f"{n}_{u}": getattr(spans, f"{n}_{u}")
            for n in spans.NAMES for u in ("ns", "n")}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters().items()}


def _collection(tmp_path, vecs, dims=DIMS, bits=8):
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "spans.dat"), distance_method=tdb.COSINE,
        dimension_count=dims, quantization=bits, create_and_overwrite=True,
        index_seed=5), device="cpu")
    ids = list(range(len(vecs)))
    c.add_documents(ids, vecs, [json.dumps({"i": i}).encode() for i in ids])
    return c


@pytest.fixture
def coll(tmp_path, device_path):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((24, DIMS))
    vecs = centers[rng.integers(0, 24, N)] + 0.3 * rng.standard_normal(
        (N, DIMS))
    c = _collection(tmp_path, vecs)
    yield c, vecs
    c.close()


def _queries(vecs, n=5, seed=4):
    rng = np.random.default_rng(seed)
    return vecs[rng.integers(0, len(vecs), n)] + 0.05 * rng.standard_normal(
        (n, vecs.shape[1]))


def _high(qs, k=10):
    return [tdb.SearchArgs(vector=q, k=k, precision="high") for q in qs]


def _exact(qs, k=10):
    return [tdb.SearchArgs(vector=q, k=k, precision="exact") for q in qs]


def _radius(qs, radius=0.2):
    return [tdb.SearchArgs(vector=q, radius=radius, precision="high")
            for q in qs]


def _filtered(args, query="i < 1500"):
    for a in args:
        a.filter_query = query
    return args


# each way into the search path -> its results
CALLS = {
    "search_many": lambda c, qs: c.search_many(_high(qs)),
    "search_many_exact": lambda c, qs: c.search_many(_exact(qs)),
    "radius_many": lambda c, qs: c.radius_many(_radius(qs)),
    "search": lambda c, qs: [c.search(_high(qs[:1])[0])],
    "search_radius": lambda c, qs: [c.search(_radius(qs[:1])[0])],
    "search_many_filtered": lambda c, qs: c.search_many(_filtered(_high(qs))),
    "radius_many_filtered": lambda c, qs: c.radius_many(
        _filtered(_radius(qs))),
}


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _never(*a, **kw):
    raise AssertionError("a profiler range was entered with tracing off")


def test_off_touches_no_counter_and_no_profiler(coll, monkeypatch):
    c, vecs = coll
    monkeypatch.setattr(torch.profiler, "record_function", _never)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _never)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _never)
    before = _counters()
    qs = _queries(vecs)
    for fn in CALLS.values():
        assert fn(c, qs)
    assert _delta(before) == {k: 0 for k in before}


def test_off_span_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    got = {spans.span(n, 7) for n in spans.NAMES}
    assert got == {spans._OFF}
    with spans.span("fetch", 7):
        pass


def test_on_high_without_escalation(coll):
    c, vecs = coll
    before = _counters()
    with _cpu_profile():
        res = c.search_many(_high(_queries(vecs)))
    d = _delta(before)
    assert len(res) == 5 and all(len(r.results) == 10 for r in res)
    assert (d["dispatch_n"], d["fetch_n"], d["escalate_n"],
            d["results_n"]) == (1, 1, 0, 1)
    assert d["escalate_ns"] == 0
    assert all(d[f"{n}_ns"] > 0 for n in ("dispatch", "fetch", "results"))


def test_on_forced_escalation(tmp_path, device_path):
    db, q, want = _tie_corpus()
    c = _collection(tmp_path, db, dims=16, bits=32)
    try:
        before = _counters()
        with _cpu_profile():
            res = c.search_many(_high([q]))
        d = _delta(before)
    finally:
        c.close()
    assert [r.id for r in res[0].results] == want
    assert d["escalate_n"] >= 1 and d["escalate_ns"] > 0
    assert d["fetch_n"] == d["escalate_n"] + 1
    assert (d["dispatch_n"], d["results_n"]) == (1, 1)


@pytest.mark.parametrize("how", sorted(CALLS))
def test_on_every_entry_point_fires_its_spans(coll, how):
    c, vecs = coll
    before = _counters()
    with _cpu_profile():
        CALLS[how](c, _queries(vecs))
    d = _delta(before)
    assert (d["dispatch_n"], d["results_n"]) == (1, 1)
    assert d["fetch_n"] >= 1 and d["fetch_n"] == d["escalate_n"] + 1
    # the filter's work, once in the dispatch and once in each round
    assert d["filter_n"] == (1 + d["escalate_n"] if "filtered" in how
                             else 0)


def _span_events(prof) -> list:
    return [(e.name(), e.kwinputs().get("call"))
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("syzgy.")]


def test_profiler_events_carry_the_call_id(coll):
    c, vecs = coll
    qs = _queries(vecs)
    with _cpu_profile(record_shapes=True) as prof:
        c.search_many(_high(qs))
        c.search_many(_high(qs))
    ev = _span_events(prof)
    ids = {n: [i for m, i in ev if m == f"syzgy.{n}"]
           for n in ("dispatch", "fetch", "results")}
    assert len(ids["dispatch"]) == 2 and ids["dispatch"][0] != \
        ids["dispatch"][1]
    assert all(isinstance(i, int) for i in ids["dispatch"])
    assert ids["results"] == ids["fetch"] == ids["dispatch"]


def test_finish_on_another_thread_keeps_the_call_id(coll, monkeypatch):
    """search_many_async's finish() run on another thread: its spans carry
    the dispatch's call identifier (spans forced on in every thread)."""
    c, vecs = coll
    seen = []

    def span(name, call):
        seen.append((name, call, threading.get_ident()))
        return spans._OFF

    monkeypatch.setattr(spans, "span", span)
    fins = [c.search_many_async(_high(_queries(vecs, seed=s)))
            for s in (1, 2)]
    ts = [threading.Thread(target=f) for f in fins]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    main = threading.get_ident()
    calls = [call for name, call, th in seen if name == "dispatch"]
    assert len(calls) == 2 and calls[0] != calls[1]
    assert all(th == main for name, _, th in seen if name == "dispatch")
    for call in calls:
        rest = sorted(name for name, k, th in seen
                      if k == call and name != "dispatch")
        assert rest == ["fetch", "results"]
        assert all(th != main for name, k, th in seen
                   if k == call and name != "dispatch")


def test_names_stay_clear_of_the_benchmarks_spans(coll):
    from portbench.trace import SPANS

    assert not {f"syzgy.{n}" for n in spans.NAMES} & set(SPANS)
    c, vecs = coll
    with _cpu_profile() as prof:
        for fn in CALLS.values():
            fn(c, _queries(vecs))
    seen = {n for n, _ in _span_events(prof)}
    assert {f"syzgy.{n}" for n in ("dispatch", "fetch", "results")} <= seen
    assert seen <= {f"syzgy.{n}" for n in spans.NAMES}


def _flat(results) -> list:
    return [(r.percent_searched,
             [(x.id, x.distance, x.metadata) for x in r.results])
            for r in results]


@pytest.mark.parametrize("how", sorted(CALLS))
def test_results_equal_with_spans_on_and_off(coll, how):
    c, vecs = coll
    qs = _queries(vecs, n=9, seed=6)
    off = _flat(CALLS[how](c, qs))
    with _cpu_profile():
        on = _flat(CALLS[how](c, qs))
    assert on == off and off[0][1]


def test_counters_exact_across_threads():
    """Recorded spans from more threads than cores, switching often:
    every update lands."""
    before = _counters()
    threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                with spans._recorded("escalate", i):
                    pass
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    d = _delta(before)
    assert d["escalate_n"] == threads * per
    assert d["escalate_ns"] > 0
    assert d["dispatch_n"] == d["fetch_n"] == d["results_n"] == 0

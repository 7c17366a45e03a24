"""The 99% filter cell (VectorDBBench Performance768D1M99P) found by name,
the readers of its three per-layer metrics on fixed runs (and nothing
where the program has no such counter, as at a parent without them), a
tiny run of the cell on the CPU, a fault the filter check catches, and
the filtered control at a size a test run holds."""

import json
import time

import pytest
import torch

from conftest import tiny_tree
from portbench import harness, roofline
from portbench.harness import RunRecord, reader
from portbench.trace import Trace

CELL = "cohere768-1m.filter99-high-b1024"
NEW = ["filter_ms_per_call", "scored_per_passing_row",
       "filtered_roofline_pct"]
SPAN = "syzgydb_tpu_torch.utils.spans:"
SCAN = "syzgydb_tpu_torch.ops.scan:"


def test_the_cell_loads_by_name(spec):
    cell = harness.Cell(spec, CELL)
    cfg, tr = cell.config, cell.traffic
    assert (cfg["name"], cfg["rows"], cfg["dims"], cfg["metric"],
            cfg["quantization"], cfg["reduced"]) == (
        "vdbbench-cohere-768d-1m", 1_000_000, 768, "cosine", 8, [])
    assert "filter" in cfg["guarantees"]
    assert tr["filter"] == {"field": "i", "op": ">=", "value": 990_000}
    assert tr["limits"]["filter_bad"] == 0 and cell.chips == 1
    assert cell.caller.__name__ == "portbench.callers.filtered_search_many"
    assert {m["name"] for m in cell.end_to_end} == {
        "qps", "p95_ms", "device_peak_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == NEW
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "qps"
    for other in spec["workloads"]:
        if other["name"] != CELL:
            got = harness.Cell(spec, other["name"]).per_layer
            assert not {m["name"] for m in got} & set(NEW)


class _Cell:
    config = {"rows": 1_000_000, "dims": 768, "quantization": 8}
    traffic = {"batch": 1024, "k": 10,
               "filter": {"field": "i", "op": ">=", "value": 990_000}}


def _run(counters=None, trace=None) -> RunRecord:
    run = RunRecord(_Cell)
    run.calls = [(0.0, 1.0, 1024), (1.0, 2.0, 1024), (2.0, 3.0, 1024),
                 (3.0, 4.0, 1024)]
    run.queries = 4096
    run.counters = counters or {}
    run.trace = trace
    return run


def test_filter_ms_reader():
    mod = reader("filter_ms_per_call")
    assert mod.COUNTERS == (SPAN + "filter_ns",)
    assert mod.compute(_run({SPAN + "filter_ns": 2_000_000})) == \
        pytest.approx(0.5)


def test_scored_per_passing_row_reader():
    mod = reader("scored_per_passing_row")
    assert mod.COUNTERS == (SCAN + "pairs_scored",)
    # every query scored every row of a 2^20-row capacity once
    got = mod.compute(_run({SCAN + "pairs_scored": 4096 * (1 << 20)}))
    assert got == pytest.approx((1 << 20) / 10_000)


def _trace(busy_per_call: float) -> Trace:
    calls = [(float(i), float(i) + 1.0) for i in range(4)]
    ops = [("k1", a, a + busy_per_call) for a, _ in calls]
    return Trace(ops, {"window": [(0.0, 4.0)], "call": calls})


def test_filtered_roofline_reader():
    from portbench.metrics.filtered_roofline_pct import least_work
    ops, nbytes = least_work(queries=1024, rows=1_000_000, passing=10_000,
                             dims=768, bits=8, results=10)
    assert ops == 2 * 1024 * 10_000 * 768
    assert nbytes == 10_000 * 768 + 10_000 * 4 + 1024 * 768 * 4 \
        + 1024 * 10 * 12 + 1_000_000 / 8
    least = roofline.least_seconds(ops, nbytes)
    assert least == pytest.approx(ops / roofline.BF16_FLOPS)
    got = reader("filtered_roofline_pct").compute(_run(trace=_trace(0.0125)))
    assert got == pytest.approx(100.0 * least / 0.0125)
    assert 0.05 < got < 0.5


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_source_returns_nothing(name):
    mod = reader(name)
    counters = getattr(mod, "COUNTERS", ())
    assert mod.compute(_run({c: None for c in counters})) is None
    assert mod.compute(_run({})) is None
    assert mod.compute(_run(trace=Trace([], {}))) is None
    run = _run({c: 5 for c in counters}, trace=_trace(0.01))
    assert mod.compute(run) is not None
    run.traffic = {"batch": 1024, "k": 10}      # no filter
    assert (mod.compute(run) is None) == (name != "filter_ms_per_call")


def _tiny(tmp_path, spec, **kw):
    """The tiny tree, the predicate cut to the same 1% of its rows."""
    rows = kw.get("rows", 12000)
    tspec, root, bench = tiny_tree(tmp_path, spec, **kw)
    path = tmp_path / "traffic" / "filter99-high-b1024.json"
    tr = json.loads(path.read_text())
    tr["filter"]["value"] = int(rows * 0.99)
    path.write_text(json.dumps(tr))
    return harness.Cell(tspec, CELL, root=root, bench=bench)


def _filter_dropped(monkeypatch, coll):
    from syzgydb_tpu_torch.core.collection import Collection
    orig = Collection.search_many_async

    def broken(self, args):
        for a in args:
            a.filter_query = None
        return orig(self, args)
    monkeypatch.setattr(Collection, "search_many_async", broken)


@pytest.mark.parametrize("fault", [None, "filter_dropped"])
def test_tiny_traced_run_on_the_cpu(tmp_path, spec, monkeypatch, fault):
    """The cell cut to a tiny size runs whole on the CPU with the program's
    device path on its plain kernels: correct, its counters read and no
    device trace; with the filter dropped under it, not correct."""
    from syzgydb_tpu_torch.core import collection

    monkeypatch.setattr(collection, "HOST_SCAN_MAX_ELEMS", 0)
    cell = _tiny(tmp_path, spec)
    hook = None if fault is None else \
        (lambda coll: _filter_dropped(monkeypatch, coll))
    r = harness.run_cell(cell, 2**31 + 23, 1.0, True, torch.device("cpu"),
                         time.perf_counter(), faults=hook)
    if fault:
        assert not r["correct"] and r["checks"]["filter_bad"]["value"] > 0
        return
    assert r["correct"], r["checks"]
    assert r["checks"]["filter_bad"]["value"] == 0
    m = r["metrics"]
    assert m["filter_ms_per_call"]["value"] > 0
    # 1% of 12,000 rows pass; the scan scores the 16,384-row capacity
    assert m["scored_per_passing_row"]["value"] >= 16384 / 120
    assert "filtered_roofline_pct" not in m


def test_control_fails_the_limits(tmp_path, spec):
    from portbench import control_filtered
    c = _tiny(tmp_path, spec, rows=6000, dims=384)
    for seed in (1, 2**31 + 3):
        got = control_filtered.readings(c, seed, torch.device("cpu"))
        verdict = {name: all(x["ok"] for x in harness.judge(
            nums, c.traffic["limits"]).values()) for name, nums in got.items()}
        assert verdict == {"reference": True, "int4": False, "bf16": False}
        assert all(nums["filter_bad"] == 0 for nums in got.values())

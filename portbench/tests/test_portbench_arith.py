"""The yardstick's arithmetic on fixed inputs: percentiles,
the roofline, the trace's busy time, gaps and labels, and the metric
readers."""

import math

import pytest

from portbench import roofline, stats
from portbench.harness import RunRecord, reader
from portbench.trace import Trace, union


def test_percentile_interpolates_like_numpy():
    xs = [10, 1, 7, 3, 5]
    assert stats.percentile(xs, 0) == 1
    assert stats.percentile(xs, 100) == 10
    assert stats.percentile(xs, 50) == 5
    # position 0.95 * 4 = 3.8 -> 7 + 0.8 * (10 - 7)
    assert stats.percentile(xs, 95) == pytest.approx(9.4)
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)


def test_scan_work_and_least_time():
    ops, nbytes = roofline.scan_work(queries=1024, rows=1_600_000, dims=384,
                                     bits=8, results=10)
    assert ops == 2 * 1024 * 1_600_000 * 384
    assert nbytes == 1_600_000 * 384 + 1_600_000 * 4 + 1024 * 384 * 4 \
        + 1024 * 10 * 12
    # bound by operations: 1.2583 TFLOP at 989 TFLOP/s
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        ops / 989e12)
    ops, nbytes = roofline.scan_work(queries=128, rows=1_600_000, dims=384,
                                     bits=8, results=50)
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        nbytes / 3.35e12)   # bound by bytes at Q = 128
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        1.8554e-4, rel=1e-3)


def _trace():
    # device: [0,1] [2,3] [2.5,4]; calls [0,2] and [2,5]; finish [1.2,2]
    ops = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k1", 2.5, 4.0)]
    spans = {"window": [(0.0, 5.0)], "call": [(0.0, 2.0), (2.0, 5.0)],
             "finish": [(1.2, 2.0)]}
    return Trace(ops, spans)


def test_trace_busy_gaps_and_labels():
    assert union([(2, 3), (0, 1), (2.5, 4)]) == [(0, 1), (2, 4)]
    t = _trace()
    assert t.busy_s() == 3.0 and t.window_s == 5.0
    assert t.busy_within(0.5, 2.5) == 1.0
    assert t.gaps() == [(1.0, 2.0), (4.0, 5.0)]
    assert t.label(1.75) == "finish" and t.label(4.5) == "call"
    b = t.breakdown()
    assert b["device_ops"] == [["k1", 2.5], ["k2", 1.0]]
    assert b["idle_gaps"] == [["finish", 1.0], ["call", 1.0]]


class _Cell:
    config = {"rows": 1_600_000, "dims": 384, "quantization": 8}
    traffic = {"batch": 1024, "k": 10}


def test_readers_on_a_fixed_run():
    run = RunRecord(_Cell)
    run.calls = [(0.0, 2.0, 1024), (2.0, 5.0, 1024)]
    run.queries, run.window_s, run.setup_s = 2048, 5.0, 40.0
    run.peak_bytes = 3 << 30
    run.counters = {c: 1 for c in reader("scan_launches_per_call").COUNTERS}
    run.trace = _trace()
    got = {n: reader(n).compute(run) for n in (
        "qps", "p95_ms", "device_peak_gib", "setup_s", "host_ms_per_call",
        "assemble_ms_per_call", "scan_launches_per_call",
        "scan_roofline_pct", "device_idle_pct")}
    assert got["qps"] == 2048 / 5.0
    assert got["p95_ms"] == pytest.approx(2950.0)
    assert got["device_peak_gib"] == 3.0 and got["setup_s"] == 40.0
    # host: (2 - 1) + (3 - 2) seconds over 2 calls
    assert got["host_ms_per_call"] == pytest.approx(1000.0)
    assert got["assemble_ms_per_call"] == pytest.approx(800.0)
    assert got["scan_launches_per_call"] == 1.5
    least = 2 * 1024 * 1_600_000 * 384 / 989e12
    assert got["scan_roofline_pct"] == pytest.approx(100 * least / 1.5)
    assert got["device_idle_pct"] == pytest.approx(40.0)


def test_readers_with_nothing_to_read_return_nothing():
    run = RunRecord(_Cell)
    for n in ("host_ms_per_call", "assemble_ms_per_call",
              "scan_roofline_pct", "device_idle_pct"):
        assert reader(n).compute(run) is None
    run.trace = Trace([], {"window": [(0.0, 1.0)], "call": [(0.0, 1.0)]})
    for n in ("host_ms_per_call", "scan_roofline_pct", "device_idle_pct"):
        assert reader(n).compute(run) is None
    run.calls = [(0.0, 1.0, 8)]
    run.counters = {c: None for c in
                    reader("scan_launches_per_call").COUNTERS}
    assert reader("scan_launches_per_call").compute(run) is None
    assert not math.isnan(reader("qps").compute(run) or 0.0)

"""The GIST-960 cell (16-bit codes, Euclidean distance) found by name, and
the readers of its two new per-layer metrics on fixed runs: rerank rows a
query and the scan kernels' roofline share, and nothing where the counter
or the trace is missing."""

import os
import re
import time

import pytest
import torch

from conftest import ROOT, tiny_tree
from portbench import harness, roofline
from portbench.harness import RunRecord, reader
from portbench.trace import Trace

CELL = "gist960-450k-l2-q16.high-b1024"
OLD_CELLS = ("tweets384-1.6m.high-b1024", "openai1536-500k.high-b1024")
SCAN = "syzgydb_tpu_torch.ops.scan:"
NEW = ["scan_kernel_roofline_pct", "rerank_rows_per_query"]


def test_the_cell_loads_by_name(spec):
    cell = harness.Cell(spec, CELL)
    cfg = cell.config
    assert (cfg["name"], cfg["rows"], cfg["dims"], cfg["metric"],
            cfg["quantization"]) == ("annb-gist-960-euclidean-q16",
                                     1_000_000, 960, "euclidean", 16)
    assert cfg["reduced"] == []
    assert cell.entry["traffic"] == "high-b1024" and cell.chips == 1
    assert cell.caller.__name__ == "portbench.callers.search_many"
    assert {m["name"] for m in cell.end_to_end} == {
        "qps", "p95_ms", "device_peak_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == NEW
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "qps"
    # the cells that were there report none of the new metrics
    for other in OLD_CELLS:
        assert not {m["name"] for m in harness.Cell(spec, other).per_layer} \
            & set(NEW)


class _Cell:
    config = {"rows": 450_000, "dims": 960, "quantization": 16}
    traffic = {"batch": 1024, "k": 10}


def _run(counters=None, trace=None) -> RunRecord:
    run = RunRecord(_Cell)
    run.calls = [(0.0, 1.0, 1024), (1.0, 2.0, 1024), (2.0, 3.0, 1024),
                 (3.0, 4.0, 1024)]
    run.queries = 4096
    run.counters = counters or {}
    run.trace = trace
    return run


@pytest.mark.parametrize("counters,queries,want", [
    ({SCAN + "rerank_rows": 4096 * 17 * 32}, 4096, 544.0),
    ({SCAN + "rerank_rows": None}, 4096, None),
    ({}, 4096, None),
    ({SCAN + "rerank_rows": 4096}, 0, None)])
def test_rerank_rows_reader(counters, queries, want):
    """Rows a query sent; None where the program has no such counter (the
    harness reads None) or no query was sent."""
    mod = reader("rerank_rows_per_query")
    assert mod.COUNTERS == (SCAN + "rerank_rows",)
    run = _run(counters)
    run.queries = queries
    got = mod.compute(run)
    assert got == (None if want is None else pytest.approx(want))


def _trace(ops) -> Trace:
    return Trace(ops, {"window": [(0.0, 4.0)],
                       "call": [(0.0, 2.0), (2.0, 4.0)]})


def test_scan_kernel_roofline_reads_the_scan_kernels_alone():
    """Two calls; the fp32 tile loop runs 0.030 s in the first and the int8
    route 0.010 s in the second (0.005 s of it overlapping a second scan
    kernel), beside other device work that does not count."""
    ops = [("void scan_kernel<16, 128, SegMinEpi<32> >(Args)", 0.1, 0.13),
           ("at::native::tensor_kernel_scan_innermost_dim<float>", 0.2, 0.9),
           ("cub::DeviceScanKernel<>", 0.9, 1.5),
           ("segmin_i8_res_kernel<16, SegMin<32>>", 2.0, 2.01),
           ("segmin_i8_stream_kernel<SegMin<32>>", 2.005, 2.01),
           ("volta_sgemm_128x64_nn", 2.5, 3.5)]
    got = reader("scan_kernel_roofline_pct").compute(_run(trace=_trace(ops)))
    least = roofline.least_seconds(*roofline.scan_work(
        queries=1024, rows=450_000, dims=960, bits=16, results=10))
    assert got == pytest.approx(100.0 * least / 0.020)
    assert 0.0 < got < 100.0


def test_scan_kernel_roofline_without_a_trace_or_a_scan_kernel():
    mod = reader("scan_kernel_roofline_pct")
    assert mod.compute(_run()) is None
    assert mod.compute(_run(trace=_trace(
        [("volta_sgemm_128x64_nn", 0.5, 1.0)]))) is None
    assert mod.compute(_run(trace=Trace([], {}))) is None


def test_tiny_traced_run_on_the_cpu(tmp_path, spec, monkeypatch):
    """The cell cut to a tiny size runs whole on the CPU with the program's
    device path on its plain kernels: correct; the rerank counter reads,
    and there is no device trace to read."""
    from syzgydb_tpu_torch.core import collection

    monkeypatch.setattr(collection, "HOST_SCAN_MAX_ELEMS", 0)
    tspec, root, bench = tiny_tree(tmp_path, spec)
    cell = harness.Cell(tspec, CELL, root=root, bench=bench)
    r = harness.run_cell(cell, 2**31 + 17, 1.0, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["rerank_rows_per_query"]["value"] >= (10 + 6 + 1) * 32
    assert "scan_kernel_roofline_pct" not in m


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_on_the_card(tmp_path, spec, trace, cuda_device):
    tspec, root, bench = tiny_tree(tmp_path, spec, rows=200_000, dims=960,
                                   pool=1024)
    c = harness.Cell(tspec, CELL, root=root, bench=bench)
    r = harness.run_cell(c, 7, 2.0, bool(trace), cuda_device,
                         time.perf_counter())
    assert r["correct"], r["checks"]
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) == want
    if trace:
        assert r["metrics"]["scan_kernel_roofline_pct"]["value"] > 0.0
        ops = [n for n, _ in r["breakdown"]["device_ops"]]
        assert not any("segmin_i8" in n for n in ops)
        assert any("scan_kernel" in n for n in ops)


def _global_kernels(path: str) -> list:
    with open(path) as f:
        src = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(", src)


@pytest.mark.parametrize("source,scan", [
    ("scan_tile.cuh", True), ("segmin_i8.cu", True), ("hamming.cu", False),
    ("mma_rate.cu", False)])
def test_the_matcher_finds_the_scan_kernels_by_their_names(source, scan):
    """Every kernel the scan's sources define is matched as the profiler
    names it (`void ns::name<...>(...)`), and no other kernel is: a renamed
    scan kernel fails here, not as a silent None in a traced run."""
    match = reader("scan_kernel_roofline_pct").MATCH
    names = _global_kernels(os.path.join(ROOT, "syzgydb_tpu_torch", "csrc",
                                         source))
    assert names
    for name in names:
        traced = f"void ns::{name}<16, (anonymous namespace)::X<32> >(Args)"
        assert bool(match.search(traced)) == scan, traced

"""A tiny run of each cell on the card (marked cuda: skips without one).
Run on a card: python3 -m pytest portbench/tests -m cuda"""

import time

import pytest

from conftest import tiny_tree


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tweets384-1.6m.high-b1024",
                                  "openai1536-500k.high-b1024",
                                  "radius.tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_on_the_card(tmp_path, spec, cell, trace, cuda_device):
    from portbench import harness
    tspec, root, bench = tiny_tree(tmp_path, spec, rows=200_000, dims=384,
                                   pool=1024)
    c = harness.Cell(tspec, cell, root=root, bench=bench)
    r = harness.run_cell(c, 7, 2.0, bool(trace), cuda_device,
                         time.perf_counter())
    assert r["correct"], r["checks"]
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) == want

"""The readers of the program's span counters (syzgydb_tpu_torch.utils.spans)
on fixed runs: ms or rounds per call, and nothing where the program has
no such counter."""

import json
import os

import pytest

from conftest import ROOT
from portbench.harness import RunRecord, reader

SPAN = "syzgydb_tpu_torch.utils.spans:"
# reader -> (its counter, the counter's value, what it reads over 4 calls)
READERS = {
    "dispatch_ms_per_call": ("dispatch_ns", 22_000_000, 5.5),
    "fetch_ms_per_call": ("fetch_ns", 12_000_000, 3.0),
    "results_ms_per_call": ("results_ns", 200_000_000, 50.0),
    "escalations_per_call": ("escalate_n", 1, 0.25),
}
CELLS = ["tweets384-1.6m.high-b1024", "openai1536-500k.high-b1024"]


class _Cell:
    config = {"rows": 1_600_000, "dims": 384, "quantization": 8}
    traffic = {"batch": 1024, "k": 10}


def _run(counters) -> RunRecord:
    run = RunRecord(_Cell)
    run.calls = [(0.0, 1.0, 1024), (1.0, 2.0, 1024), (2.0, 3.0, 1024),
                 (3.0, 4.0, 1024)]
    run.counters = counters
    return run


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_fixed_run(name):
    counter, value, want = READERS[name]
    mod = reader(name)
    assert mod.COUNTERS == (SPAN + counter,)
    assert mod.compute(_run({SPAN + counter: value})) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_the_counter_returns_nothing(name):
    mod = reader(name)
    assert mod.compute(_run({c: None for c in mod.COUNTERS})) is None
    assert mod.compute(_run({})) is None
    run = _run({c: 5 for c in mod.COUNTERS})
    run.calls = []
    assert mod.compute(run) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_entries_read_the_program_in_both_cells(name):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry = {m["name"]: m for m in spec["per_layer"]}[name]
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == CELLS
    assert entry["moves"] == ("p95_ms" if name == "escalations_per_call"
                              else "qps")


def test_the_harness_reads_missing_counters_as_none():
    """The parent commit has no spans module: its counters read None."""
    from portbench.harness import _counter_values

    got = _counter_values([SPAN + "dispatch_ns",
                           "syzgydb_tpu_torch.utils.no_such_module:x"])
    assert got["syzgydb_tpu_torch.utils.no_such_module:x"] is None
    assert got[SPAN + "dispatch_ns"] is not None

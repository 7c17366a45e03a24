"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_units_and_texts(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}


def test_configs_state_their_deployment(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["metric"] in ("cosine", "euclidean")
        for key in ("rows", "dims", "quantization", "generator",
                    "guarantees", "assumed", "ingest_chunk"):
            assert key in cfg


def test_every_cell_loads_by_name(spec):
    from portbench import harness

    for w in spec["workloads"]:
        cell = harness.Cell(spec, w["name"])
        for fn in ("setup", "call", "check"):
            assert callable(getattr(cell.caller, fn))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]).compute)
        assert set(cell.traffic["limits"]) >= {"shape_bad", "meta_bad",
                                               "stored_bad", "failed"}
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_added_files_are_found_without_edits(tmp_path):
    """A copy of the benchmark with a new configuration, mix, metric and
    cell added as files and entries: the harness finds them all."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "syzgy-tweets-384d-1.6m.json")
                     .read_text())
    cfg.update(name="added-cfg", rows=1000)
    (bench / "configs" / "added-cfg.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "high-b1024.json").read_text())
    tr.update(k=100)
    (bench / "traffic" / "added-mix.json").write_text(json.dumps(tr))
    (bench / "metrics" / "added_metric.py").write_text(
        "COUNTERS = ()\n\ndef compute(run):\n    return 42.0\n")
    spec["configs"].append({"name": "added-cfg", "source": "a test",
                            "file": "portbench/configs/added-cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "added-cell", "config": "added-cfg",
                              "traffic": "added-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "added_metric", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "a test", "moves": "qps",
                              "workloads": ["added-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys; sys.path.insert(0, '.');"
        "from portbench import harness;"
        "spec = json.load(open('BENCHMARK.json'));"
        "c = harness.Cell(spec, 'added-cell');"
        "print(json.dumps([c.config['rows'], c.traffic['k'],"
        " [m['name'] for m in c.per_layer],"
        " harness.reader('added_metric').compute(None),"
        " harness.__file__]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    rows, k, per_layer, value, where = json.loads(out.stdout)
    assert (rows, k, per_layer, value) == (1000, 100, ["added_metric"], 42.0)
    assert where.startswith(str(tmp_path))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    the run exits nonzero and prints no result."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tweets384-1.6m.high-b1024", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    """Here there is no CUDA device: the run exits nonzero, prints no
    result and says why."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tweets384-1.6m.high-b1024", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr

"""Tests of the benchmark itself (run: python -m pytest portbench/tests).

They import neither JAX nor the JAX package.  Tests marked `cuda` need an
NVIDIA GPU and skip elsewhere.
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (torch.cuda.is_available()); "
        "skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_tree(tmp_path, spec, rows=12000, dims=64, pool=256):
    """A BENCHMARK.json with every cell of `spec`, and a radius cell, cut
    to a tiny configuration and pool, its config and traffic files beside
    it -> (spec, root, bench folder)."""
    root = tmp_path
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    out = dict(spec)
    out["configs"] = []
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(rows=rows, dims=dims, ingest_chunk=rows // 3 + 1,
                   generator={"centers": 64, "spread": 0.35, "seed": 5})
        path = root / "configs" / (c["name"] + ".json")
        path.write_text(json.dumps(cfg))
        out["configs"].append(dict(c, file=str(path.relative_to(root))))
    # the radius mix, which no cell of BENCHMARK.json runs, on the first
    # configuration
    out["workloads"] = list(spec["workloads"]) + [{
        "name": "radius.tiny", "config": spec["configs"][0]["name"],
        "traffic": "radius-high-b128", "chips": 1, "why": "tests"}]
    for w in out["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")) as f:
            tr = json.load(f)
        tr.update(pool=pool, batch=min(tr["batch"], 32), sample_calls=3,
                  stored_sample=64)
        (root / "traffic" / (w["traffic"] + ".json")).write_text(
            json.dumps(tr))
    (root / "BENCHMARK.json").write_text(json.dumps(out))
    return out, str(root), str(root)

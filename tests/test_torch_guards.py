"""Guards of the port's boundaries: it never imports JAX or the JAX
package (nor optax, msgpack, transformers or safetensors), it never carries on
on the CPU when CUDA was asked for, and its chip smoke script refuses to
run without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import syzgydb_tpu_torch as tdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "syzgydb_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


# the JAX package and its stack (optax: the port's AdamW is torch's);
# msgpack, transformers and safetensors are absent where the card is, and
# the embedder's checkpoint readers stand alone
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "syzgydb_tpu", "msgpack",
             "transformers", "safetensors")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_files() if p != SMOKE)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_collection_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "c.dat"
    with pytest.raises(RuntimeError, match="CUDA"):
        tdb.Collection(tdb.CollectionOptions(name=str(path),
                                             dimension_count=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdb.Collection(tdb.CollectionOptions(name=str(path),
                                             dimension_count=4),
                       device="cuda")
    assert not path.exists()  # refused before any file was written


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = SMOKE
    cwd = ROOT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, script], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok"))


def test_fp32_products_never_ride_tf32(monkeypatch):
    """Every fp32 product of the port runs with TF32 off, even when the
    caller switched it on, and the caller's setting comes back after."""
    import numpy as np
    from syzgydb_tpu_torch.index import hamming as tham
    from syzgydb_tpu_torch.ops import distance as tdist
    from syzgydb_tpu_torch.ops import scan as tscan

    seen = []
    real_matmul, real_einsum = torch.Tensor.__matmul__, torch.einsum

    def matmul(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(a, b)

    def einsum(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*args)

    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(torch, "einsum", einsum)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(0)
    for bits in (4, 8, 16, 32):
        db = rng.uniform(-1, 1, size=(256, 15))
        _, codes, norms = tdist.ingest_reprs(db, bits)
        q = torch.from_numpy(np.float32(db[:3]))
        c, n = torch.from_numpy(codes), torch.from_numpy(norms)
        v = torch.ones(256, dtype=torch.bool)
        tscan.score_surface(q, c, n, v, bits=bits, metric="cosine",
                            exact=True)
        tscan.surface_topk(q, c, n, v, bits=bits, metric="cosine", k=3,
                           margin=8)
        tscan.fused_scan_topk(q, c, n, v, bits=bits, metric="euclidean",
                              k=3, with_ties=True)
    idx = tham.SignHashIndex(15, "cosine", tdb.MyRandom(3))
    idx.encode_codes_device(c, 32)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_make_mesh_without_cuda_raises():
    """make_mesh() takes every CUDA device and raises without one: it never
    builds a CPU mesh in their place (a CPU mesh comes only from an
    explicit devices list)."""
    from syzgydb_tpu_torch.parallel import mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert mesh.visible_devices() == []
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh(mesh.MeshConfig(data=2))
    cpu = mesh.make_mesh(mesh.MeshConfig(data=2),
                         devices=[torch.device("cpu")] * 2)
    assert cpu.shape == {"data": 2, "feature": 1}

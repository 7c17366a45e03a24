"""What the benchmark's files import, by whole top-level module name."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "syzgydb_tpu"}


def _imports(path):
    """Top-level names of every module the file imports (relative
    imports stay inside the benchmark)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for dirpath, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_whole_names_are_compared():
    assert "syzgydb_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "syzgydb_tpu.core".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    got = set(_imports(path))
    assert "syzgydb_tpu_torch" not in got and not got & FORBIDDEN


def test_the_run_checks_loaded_modules():
    import sys

    from portbench import harness
    assert harness.FORBIDDEN == tuple(sorted(FORBIDDEN, key=[
        "jax", "jaxlib", "flax", "syzgydb_tpu"].index))
    sys.modules["syzgydb_tpu.fake"] = object()
    try:
        assert harness.forbidden_modules() == ["syzgydb_tpu"]
    finally:
        del sys.modules["syzgydb_tpu.fake"]

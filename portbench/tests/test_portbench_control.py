"""The lower-precision control at a size a test run holds: the reference
in the program's place passes the cell's limits, and 4-bit codes or
bfloat16 rows fail them.  At each cell's own size the control runs on
the card: python3 portbench/control.py --workload <cell> --seeds ..."""

import pytest

from conftest import tiny_tree


@pytest.mark.parametrize("cell", ["tweets384-1.6m.high-b1024",
                                  "radius.tiny"])
def test_control_fails_the_limits(tmp_path, spec, cell):
    import torch

    from portbench import control, harness
    tspec, root, bench = tiny_tree(tmp_path, spec, rows=6000, dims=384)
    c = harness.Cell(tspec, cell, root=root, bench=bench)
    for seed in (1, 2**31 + 3):
        got = control.readings(c, seed, torch.device("cpu"))
        verdict = {name: all(x["ok"] for x in harness.judge(
            nums, c.traffic["limits"]).values()) for name, nums in got.items()}
        assert verdict == {"reference": True, "int4": False, "bf16": False}

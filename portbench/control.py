"""The lower-precision control of a cell's comparison.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed, makes the cell's rows and query pool as a run does, and
puts the reference in the program's place computed one step below the
configuration's precision: 4-bit codes for its 8-bit codes ("int4"), and
its 8-bit rows and queries rounded to bfloat16 and summed in float32
("bf16").  Each answers as many queries as a run compares (the traffic's
`sample_calls` batches), and the float64 reference at the configuration's
precision judges the answers with the run's own comparison and limits.
Prints one JSON line a seed and control.  The benchmark's runs do not
run this; it shows that their limits fail a lower precision.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import compare, corpus, harness  # noqa: E402
from portbench.reference.exact import Reference  # noqa: E402

# answers a radius control reads per query before cutting at the radius
RADIUS_DEPTH = 1024


def controls(cfg: dict, rows) -> dict:
    import torch

    return {"int4": Reference(rows, bits=4, metric=cfg["metric"]),
            "bf16": Reference(rows, bits=cfg["quantization"],
                              metric=cfg["metric"],
                              rounding=torch.bfloat16)}


def answers_of(ctl, queries, traffic: dict, radii, device) -> list:
    """The control's answers in the program's place."""
    import torch

    if "k" in traffic:
        d, r = ctl.topk(queries, traffic["k"], device)
        keep = [np.ones(r.shape[1], dtype=bool)] * len(r)
    else:
        d, r = ctl.topk(queries, RADIUS_DEPTH, device)
        keep = list((d <= torch.as_tensor(radii)[:, None]).numpy())
    d, r = d.numpy(), r.numpy()
    return [compare.Answer(r[i][keep[i]], d[i][keep[i]],
                           [compare.meta_of(int(x)) for x in r[i][keep[i]]])
            for i in range(len(r))]


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """{control name: {number: value}} for one seed; the judge's own
    answers read as the program's would ("reference")."""
    cfg, tr = cell.config, cell.traffic
    rows, gen = corpus.make_rows(cfg["generator"], cfg["rows"], cfg["dims"],
                                 device)
    pool = corpus.make_queries(rows, gen, tr["pool"], tr["noise"])
    cell.pool = pool.double().cpu().numpy()
    cell.device = device
    cell.ref = Reference(rows, bits=cfg["quantization"], metric=cfg["metric"])
    ctls = controls(cfg, rows)
    del rows, pool
    order = corpus.Order(tr["pool"], tr["batch"], seed)
    idx = np.concatenate([order(c) for c in range(tr["sample_calls"])])
    queries = cell.pool[idx]
    radii = sets = None
    if "k" not in tr:
        radii, sets = compare.radius_truth(cell.ref, queries, tr["radius_rank"],
                                           16, device)
    out = {}
    for name, ctl in [("reference", cell.ref)] + list(ctls.items()):
        ans = answers_of(ctl, queries, tr, radii, device)
        ctl.release()
        if "k" in tr:
            nums = compare.knn_numbers(cell.ref, queries, ans, tr["k"], device)
        else:
            nums = compare.radius_numbers(cell.ref, queries, radii, sets, ans,
                                          device)
        cell.ref.release()
        out[name] = nums
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    args = p.parse_args(argv)
    import torch

    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        harness.log("the control runs on the card")
        return 3
    device = torch.device("cuda", 0)
    card = harness._card_line()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for name, nums in readings(cell, seed, device).items():
            checks = harness.judge(nums, cell.traffic["limits"])
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": name, "card": card,
                              "correct": all(c["ok"] for c in checks.values()),
                              "numbers": nums}), flush=True)
        harness.log(f"seed {seed}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

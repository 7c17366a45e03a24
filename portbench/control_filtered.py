"""The lower-precision control of a filtered cell's comparison.

    python3 portbench/control_filtered.py --workload <cell> --seeds 1,2,3

control.py for traffic with a filter: for each seed, makes the cell's
rows and query pool as a run does, and puts reference/filtered.py in the
program's place over the rows that pass the traffic's predicate, computed
one step below the configuration's precision: 4-bit codes for its 8-bit
codes ("int4"), and its 8-bit rows and queries rounded to bfloat16 and
summed in float32 ("bf16").  Each answers as many queries as a run
compares (the traffic's `sample_calls` batches), and the caller's own
check judges the answers against the float64 filtered reference at the
configuration's precision, with the traffic's limits.  Prints one JSON
line a seed and control.  The benchmark's runs do not run this; it shows
that their limits fail a lower precision.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import control, corpus, harness  # noqa: E402
from portbench.reference.exact import Reference  # noqa: E402
from portbench.reference.filtered import (  # noqa: E402
    FilteredReference, passing)


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
    ctls = control.controls(cfg, rows)
    del rows, pool
    rows = passing(tr["filter"], cell.ref.n)
    order = corpus.Order(tr["pool"], tr["batch"], seed)
    calls = [order(c) for c in range(tr["sample_calls"])]
    out = {}
    for name, ctl in [("reference", cell.ref)] + list(ctls.items()):
        place = FilteredReference(ctl, rows)
        kept = [(idx, control.answers_of(place, cell.pool[idx], tr, None,
                                         device)) for idx in calls]
        place.release()
        ctl.release()
        out[name] = cell.caller.check(None, cell, kept)
        cell.ref.release()
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
    if "filter" not in cell.traffic:
        harness.log(f"{args.workload}'s traffic has no filter: control.py")
        return 2
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

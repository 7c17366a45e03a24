"""One run of one benchmark cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name in
BENCHMARK.json; the configuration's file, the traffic's file
(traffic/<name>.json), the traffic's caller (callers/<entry>.py) and each
metric's reader (metrics/<name>.py) are looked up by those names, so a
new cell, mix or metric is new files and entries, not an edit.

A run: make the rows and a query pool from the seed on the card; the
reference quantizes them with its own codec (and the caller works out
what its traffic needs from it); build a syzgydb_tpu_torch Collection
under TMPDIR through add_documents; warm the cell's shape; drive one
caller in a closed loop for the window; read the peak memory; judge a
seeded sample of the window's answers against the reference; print the
numbers compared beside their limits on standard error and, as the last
line of standard output, one JSON result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "syzgydb_tpu")
# fixed cache directories inside the checkout, so later runs hit them
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Cell:
    """A workload with its configuration and traffic, as loaded by name."""

    def __init__(self, spec: dict, name: str, root: str = ROOT,
                 bench: str = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        with open(os.path.join(root, configs[self.entry["config"]]["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(bench, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.chips = int(self.entry["chips"])
        self.caller = importlib.import_module(
            "portbench.callers." + self.traffic["entry"])
        self.end_to_end = [m for m in spec["end_to_end"] if self._in(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._in(m)]
        # set during the run
        self.device = self.pool = self.ref = None

    def _in(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def reader(name: str):
    return importlib.import_module("portbench.metrics." + name)


class RunRecord:
    """What the window left for the metric readers."""

    def __init__(self, cell: Cell):
        self.config, self.traffic = cell.config, cell.traffic
        self.calls: list = []       # (start, end, queries), host clock
        self.queries = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.counters: dict = {}
        self.gc_s = 0.0             # garbage collection inside the window
        self.gc_full = 0
        self.trace = None


def _counter_values(names) -> dict:
    out = {}
    for name in names:
        mod, attr = name.split(":")
        try:
            out[name] = getattr(importlib.import_module(mod), attr)
        except (ImportError, AttributeError):
            out[name] = None
    return out


def _card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, faults=None) -> dict:
    """Run the cell once on `device` -> the result (without the device
    description).  `faults` (tests only) is called with the collection
    after ingest."""
    import torch

    import syzgydb_tpu_torch as tdb
    from . import compare, corpus
    from .reference.exact import Reference
    from .trace import Spans, from_profiler

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    cell.device = device
    setup = {}

    # -- data and reference ------------------------------------------------
    t = time.perf_counter()
    rows, gen = corpus.make_rows(cfg["generator"], cfg["rows"], cfg["dims"],
                                 device)
    pool = corpus.make_queries(rows, gen, tr["pool"], tr["noise"])
    cell.pool = pool.double().cpu().numpy()
    del pool
    cell.ref = Reference(rows, bits=cfg["quantization"], metric=cfg["metric"])
    rows_host = rows.cpu().numpy()
    del rows
    setup["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = cell.caller.setup(cell)
    cell.ref.release()
    setup["traffic_s"] = time.perf_counter() - t
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # -- the program -------------------------------------------------------
    t = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="portbench-")
    try:
        coll = tdb.Collection(tdb.CollectionOptions(
            name=os.path.join(folder, "bench.dat"),
            distance_method=tdb.COSINE if cfg["metric"] == "cosine"
            else tdb.EUCLIDEAN,
            dimension_count=cfg["dims"], quantization=cfg["quantization"],
            index_seed=1 + corpus.seed64(cfg["generator"]["seed"]) % (2**31 - 2)),
            device=device)
        step = cfg["ingest_chunk"]
        for a in range(0, cfg["rows"], step):
            ids = range(a, min(a + step, cfg["rows"]))
            coll.add_documents(list(ids), rows_host[a:a + step],
                               [compare.meta_of(i) for i in ids])
        del rows_host
        if faults is not None:
            faults(coll)
        setup["ingest_s"] = time.perf_counter() - t

        order = corpus.Order(tr["pool"], tr["batch"], seed)
        spans = Spans(False, device)
        t = time.perf_counter()
        cell.caller.call(state, coll, order(0), spans)
        setup["first_call_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for c in range(1, tr["warmup_calls"]):
            cell.caller.call(state, coll, order(c), spans)
        warm_call_s = (time.perf_counter() - t) / max(1, tr["warmup_calls"] - 1)
        gc.collect()
        setup["warmup_s"] = time.perf_counter() - t

        # -- the window ----------------------------------------------------
        rec = RunRecord(cell)
        counter_names = sorted({c for m in cell.per_layer
                                for c in getattr(reader(m["name"]),
                                                 "COUNTERS", ())})
        spans = Spans(trace, device)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        # the calls whose answers are judged: drawn from the seed among
        # the calls the window is expected to hold at the warm-up's pace,
        # so the harness holds only those and makes no garbage of others
        expect = max(1, int(0.8 * seconds / max(warm_call_s, 1e-3)))
        planned = set(np.random.default_rng(
            [corpus.seed64(seed), 0x6b656570]).choice(
                expect, size=min(tr["sample_calls"], expect),
                replace=False).tolist())
        kept: list = []
        failed = 0
        gc_watch = GcWatch()
        c0 = _counter_values(counter_names)
        call = tr["warmup_calls"]
        gc.callbacks.append(gc_watch)
        t0 = time.perf_counter()
        rec.setup_s = t0 - t_start
        with spans("window"):
            while True:
                idx = order(call)
                a = time.perf_counter()
                try:
                    with spans("call"):
                        res = cell.caller.call(state, coll, idx, spans)
                except Exception as exc:  # a failed call counts, the loop goes on
                    log(f"call {call} failed: {exc!r}")
                    failed += len(idx)
                    res = None
                b = time.perf_counter()
                rec.calls.append((a, b, len(idx)))
                if res is not None and len(rec.calls) - 1 in planned:
                    kept.append((idx, res))
                call += 1
                if b - t0 >= seconds:
                    break
        gc.callbacks.remove(gc_watch)
        c1 = _counter_values(counter_names)
        if prof is not None:
            prof.stop()
        rec.window_s = rec.calls[-1][1] - t0
        rec.queries = sum(q for _, _, q in rec.calls)
        rec.counters = {k: (None if c0[k] is None else c1[k] - c0[k])
                        for k in counter_names}
        rec.gc_s, rec.gc_full = gc_watch.seconds, gc_watch.full
        if cuda:
            rec.peak_bytes = torch.cuda.max_memory_allocated(device)

        # -- what the program returned -------------------------------------
        sample = np.random.default_rng([corpus.seed64(seed), 0x73746f7265]) \
            .choice(cfg["rows"], size=min(tr["stored_sample"], cfg["rows"]),
                    replace=False)
        stored_bad = compare.stored_bad(cell.ref, coll.get_document, sample)
        kept = [(idx, compare.from_results(res)) for idx, res in kept]
        coll.close()
        del coll
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference judges ------------------------------------------------
    t = time.perf_counter()
    numbers = cell.caller.check(state, cell, kept) if kept else {}
    cell.ref.release()
    numbers["stored_bad"] = stored_bad
    numbers["failed"] = failed
    checks = judge(numbers, tr["limits"])
    check_s = time.perf_counter() - t
    if trace:
        t = time.perf_counter()
        rec.trace = from_profiler(prof)
        setup["trace_parse_s"] = time.perf_counter() - t

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).compute(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(kept) and all(c["ok"] for c in checks.values()),
        "attempted": rec.queries,
        "failed": failed,
        "metrics": metrics,
        "window": {"calls": len(rec.calls), "queries": rec.queries,
                   "seconds": rec.window_s, "judged_calls": len(kept),
                   "gc_s": rec.gc_s, "gc_full": rec.gc_full,
                   "latency_ms": _latency_summary(rec.calls),
                   "counters": rec.counters},
        "setup": setup,
        "check_s": check_s,
    }
    if trace:
        result["trace_device"] = {"busy_s": rec.trace.busy_s(),
                                  "window_s": rec.trace.window_s}
        result["breakdown"] = rec.trace.breakdown()
    result["peak_bytes"] = rec.peak_bytes
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


class GcWatch:
    """Seconds the garbage collector ran, and its full collections, while
    installed in gc.callbacks."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.full += info["generation"] == 2


def _latency_summary(calls) -> dict:
    """Percentiles of the calls' latencies, ms."""
    from .stats import percentile

    lat = [(b - a) * 1e3 for a, b, _ in calls]
    return {f"p{q}": percentile(lat, q) for q in (50, 75, 90, 95, 99, 100)
            } if lat else {}


def judge(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit; a number with no limit, or NaN, fails."""
    out = {}
    for k, v in numbers.items():
        lim = limits.get(k)
        ok = lim is not None and not math.isnan(v) and v <= lim
        out[k] = {"value": v, "limit": lim, "ok": ok}
    return out


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = Cell(spec, args.workload)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    import syzgydb_tpu_torch  # noqa: F401  (no program, no run)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() "
            f"= {torch.cuda.is_available()}, device_count = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    card = _card_line()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    return emit(result, device, card)


def emit(result: dict, device, card) -> int:
    """Print the checks on standard error and the result line last on
    standard output; refuse to print one if a forbidden module loaded."""
    import torch

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": result.pop("peak_bytes")}
    tdev = result.pop("trace_device", None)
    if tdev is not None:
        dev.update(tdev)
    checks = result.pop("checks")
    out = dict(result)
    out["device"] = dev
    out["card"] = card
    out["checks"] = checks
    log(f"card: {card}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0

"""filtered_roofline_pct: the least time of each call's filtered search
as a share of the device-busy time inside each call span of the traced
run.  The least work (least_work) is roofline.scan_work's over the rows
that pass the traffic's predicate alone (reference/filtered.passing),
plus one bit a stored row for the predicate's mask, at
roofline.least_seconds.  It counts the search, not a kernel, so it holds
whatever implements the scan or the predicate.  Nothing without a trace,
device work in the call spans, or a filter."""

from ..reference import filtered
from ..roofline import least_seconds, scan_work


def least_work(*, queries: int, rows: int, passing: int, dims: int,
               bits: int, results: int) -> tuple[float, float]:
    """(operations, bytes) of `queries` searches over the `passing` rows
    of `rows` that a predicate keeps: scan_work over the passing rows,
    and the predicate's mask read once at one bit a stored row."""
    ops, nbytes = scan_work(queries=queries, rows=passing, dims=dims,
                            bits=bits, results=results)
    return ops, nbytes + rows / 8.0


def compute(run):
    t = run.trace
    pred = run.traffic.get("filter")
    calls = t.spans.get("call", []) if t else []
    busy = sum(t.busy_within(a, b) for a, b in calls) if calls else 0.0
    if busy <= 0 or pred is None:
        return None
    tr, cfg = run.traffic, run.config
    ops, nbytes = least_work(
        queries=tr["batch"], rows=cfg["rows"],
        passing=len(filtered.passing(pred, cfg["rows"])), dims=cfg["dims"],
        bits=cfg["quantization"], results=tr["k"])
    return 100.0 * least_seconds(ops, nbytes) / (busy / len(calls))

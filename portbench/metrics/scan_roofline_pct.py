"""scan_roofline_pct: the least time of each call's exhaustive search
(roofline.scan_work at the cell's rows, dims, code bits, batch and
results per query, over roofline.least_seconds) as a share of the
device-busy time inside each call span of the traced run.  The least
work counts the search, not a kernel, so it holds whatever implements
the scan."""

from ..roofline import least_seconds, scan_work


def compute(run):
    t = run.trace
    calls = t.spans.get("call", []) if t else []
    busy = sum(t.busy_within(a, b) for a, b in calls) if calls else 0.0
    if busy <= 0:
        return None
    tr, cfg = run.traffic, run.config
    ops, nbytes = scan_work(queries=tr["batch"], rows=cfg["rows"],
                            dims=cfg["dims"], bits=cfg["quantization"],
                            results=tr.get("k") or tr["radius_rank"])
    return 100.0 * least_seconds(ops, nbytes) / (busy / len(calls))

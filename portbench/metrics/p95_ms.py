"""p95_ms: the 95th percentile of the latencies of all calls in the
window (host clock, each call until its results are Python objects)."""

from ..stats import percentile


def compute(run):
    lat = [(b - a) * 1e3 for a, b, _ in run.calls]
    return percentile(lat, 95) if lat else None

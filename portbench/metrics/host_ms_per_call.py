"""host_ms_per_call: per call in the traced window, its wall time (the
benchmark's "call" span) minus the time inside it in which some device
operation ran (the profiler's device activities), averaged, in ms."""


def compute(run):
    t = run.trace
    calls = t.spans.get("call", []) if t else []
    if not calls or not t.busy:
        return None
    host = sum((b - a) - t.busy_within(a, b) for a, b in calls)
    return host / len(calls) * 1e3

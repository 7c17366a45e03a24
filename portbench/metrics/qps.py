"""qps: every query completed in the window over the window's seconds
(host clock, from the first call's start to the last call's end)."""


def compute(run):
    return run.queries / run.window_s if run.window_s > 0 else None

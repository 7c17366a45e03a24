"""device_idle_pct: 100 x (1 - the union of the device's operations in
the traced window / the window's length)."""


def compute(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

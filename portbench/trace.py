"""Spans from the benchmark's own files and the device's busy time, read
from one torch.profiler trace.

The harness marks the window and each call with
`torch.profiler.record_function`, and a caller may mark parts of a call
(dispatch, sync, finish).  The profiler's device activities (kernels,
copies, fills) give when the card was busy.  All times are seconds on
the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

# every span name the benchmark's files use, innermost last
SPANS = ("window", "call", "dispatch", "sync", "finish")


class Spans:
    """Span markers for a caller: no-ops unless the run is traced."""

    def __init__(self, on: bool, device):
        self.on = on
        self._device = device

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def synchronize(self) -> None:
        import torch
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, device_ops, spans):
        """device_ops: [(name, start, end)]; spans: {name: [(start, end)]}."""
        self.device_ops = device_ops
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.busy = union((a, b) for _, a, b in device_ops)
        self._starts = [a for a, _ in self.busy]
        w = self.spans.get("window") or [(0.0, 0.0)]
        self.window = (w[0][0], w[-1][1])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_within(self, a: float, b: float) -> float:
        """Seconds of [a, b] in which some device operation ran."""
        if b <= a or not self.busy:
            return 0.0
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        total = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, e = self.busy[i]
            total += max(0.0, min(e, b) - max(s, a))
            i += 1
        return total

    def busy_s(self) -> float:
        return self.busy_within(*self.window)

    def gaps(self) -> list:
        """Idle stretches of the window -> [(start, end)]."""
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy:
            if b <= lo or a >= hi:
                continue
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def label(self, t: float) -> str:
        """The innermost of the benchmark's spans the host was in at t
        ("harness" when in none but the window)."""
        for name in reversed(SPANS[1:]):
            ivs = self.spans.get(name, ())
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                return name
        return "harness"

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        lo, hi = self.window
        for name, a, b in self.device_ops:
            by_name[name] += max(0.0, min(b, hi) - max(a, lo))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((self.label((a + b) / 2), b - a)
                       for a, b in self.gaps()), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _ns(e, what: str) -> float:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return fn() * 1e-9
    return getattr(e, f"{what}_us")() * 1e-6


def from_profiler(prof) -> Trace:
    """A Trace from a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device_ops, spans = [], defaultdict(list)
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == DeviceType.CPU:
            if name in SPANS:
                spans[name].append((start, end))
            continue
        user = getattr(e, "is_user_annotation", None)
        if name in SPANS or (user is not None and user()):
            continue  # the device-side copy of a span, not work
        device_ops.append((name, start, end))
    return Trace(device_ops, spans)

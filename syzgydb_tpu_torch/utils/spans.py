"""Spans of the search path: the host's wall time in each stage of a call,
recorded only while a torch.profiler records in the calling thread.

`span(name, call)` wraps one stage of one search call.  With no profiler
recording it returns one shared null context and touches nothing else (one
check of the profiler's flag).  With one recording it opens a profiler
range "syzgy.<name>" (its argument `call` = the call's identifier, shown in
the trace's args when the profiler records shapes), on the clock of the
profiler's CUDA activities, and adds the span's `time.perf_counter_ns()`
length to `<name>_ns` and one to `<name>_n` below.  A span's time is host
wall time, garbage collection that fires inside it included.

The stages (core/collection.py):
  dispatch  a call's host work up to the return of its finish():
            validation, stacking and padding, the lock, the filter mask,
            the query upload, the device state, the kernels' enqueue (a
            precision="exact" search, synchronous, runs whole inside it)
  fetch     one device-to-host fetch of results, with the wait for the
            device work it reads (Collection._fetch_results)
  escalate  one re-dispatch round: the next margin rung, k, sketch
            budget or exact shortlist, the device state, the enqueue; the
            wait for the re-run kernel falls in the next fetch
  results   the margin hint and the assembly of the results, lock included
            (precision="exact" kNN: the host f64 rerank and assembly of a
            shortlist)
  filter    a filtered search's filter work in one dispatch or round: the
            mask's cache lookup or evaluation (Collection._filter_mask) and
            its upload as the validity column; it nests inside dispatch or
            escalate, and an unfiltered search never enters it

Beside the spans' counters:
  escalate_q  the queries that escalate rounds re-dispatched (a margin
              rung re-dispatches only the batch's failing queries, other
              rounds the whole batch), so escalate_q / escalate_n is the
              queries a round

The counters are plain integers, as ops/scan.py's launch counters: read
them by module attribute, and difference two readings.  Updates take a
lock, only while on.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

# every span name; the profiler's range is "syzgy." + name
NAMES = ("dispatch", "fetch", "escalate", "results", "filter")

# nanoseconds inside each span, and its count, since import
dispatch_ns = dispatch_n = 0
fetch_ns = fetch_n = 0
escalate_ns = escalate_n = 0
results_ns = results_n = 0
filter_ns = filter_n = 0
escalate_q = 0

_calls = itertools.count(1)
_lock = threading.Lock()
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def next_call() -> int:
    """A new call identifier: the dispatch and finish spans of one search
    call carry the same one, on whichever thread its finish() runs."""
    return next(_calls)


def span(name: str, call: int):
    """The span `name` of call `call`: a null context unless a profiler
    records in this thread."""
    if not _recording():
        return _OFF
    return _recorded(name, call)


def add(counter: str, n: int) -> None:
    """Add n to the counter `counter` while a profiler records in this
    thread."""
    if _recording():
        with _lock:
            globals()[counter] += n


@contextlib.contextmanager
def _recorded(name: str, call: int):
    # record_function(name, str(call)) would drop the id: its string
    # argument never reaches the trace, a keyword value does
    with torch._C._profiler._RecordFunctionFast("syzgy." + name, (),
                                                {"call": call}):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t
            g = globals()
            with _lock:
                g[name + "_ns"] += dt
                g[name + "_n"] += 1

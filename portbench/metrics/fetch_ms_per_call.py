"""fetch_ms_per_call: host time inside the program's "fetch" spans
(syzgydb_tpu_torch.utils.spans: Collection._fetch_results, each
device-to-host copy of a dispatch's results with the wait for the device
work it reads) over the traced window, per call, in ms.  The traced
caller synchronises before finish(), so the first fetch of a call waits
for nothing; a margin escalation's re-run kernel is waited for here.
Host wall time: a garbage collection inside a span counts.  Nothing where
the program has no such counter."""

COUNTERS = ("syzgydb_tpu_torch.utils.spans:fetch_ns",)


def compute(run):
    ns = run.counters.get(COUNTERS[0])
    if not run.calls or ns is None:
        return None
    return ns / len(run.calls) * 1e-6

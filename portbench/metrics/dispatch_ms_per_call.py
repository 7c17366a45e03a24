"""dispatch_ms_per_call: host time inside the program's "dispatch" spans
(syzgydb_tpu_torch.utils.spans) over the traced window, per call, in ms:
search_many_async's work before its finish() is returned (validation,
stacking and padding the queries, the lock, the filter mask, the query
upload, the device state, the kernel enqueue).  Host wall time: a garbage
collection inside a span counts.  Nothing where the program has no such
counter."""

COUNTERS = ("syzgydb_tpu_torch.utils.spans:dispatch_ns",)


def compute(run):
    ns = run.counters.get(COUNTERS[0])
    if not run.calls or ns is None:
        return None
    return ns / len(run.calls) * 1e-6

"""filter_ms_per_call: host time inside the program's "filter" spans
(syzgydb_tpu_torch.utils.spans: a filtered search's mask lookup or
evaluation and the mask's upload as the validity column, in each dispatch
and escalation round) over the traced window, per call, in ms.  Host wall
time.  Nothing where the program has no such counter."""

COUNTERS = ("syzgydb_tpu_torch.utils.spans:filter_ns",)


def compute(run):
    ns = run.counters.get(COUNTERS[0])
    if not run.calls or ns is None:
        return None
    return ns / len(run.calls) * 1e-6

"""escalations_per_call: re-dispatch rounds of the program's finish()
(syzgydb_tpu_torch.utils.spans' "escalate" spans: a margin rung or a
radius k step of finish_escalate, finish_exh or finish_ann) over the
traced window, per call.  Where each round re-runs one scan kernel it
reads scan_launches_per_call - 1.  Nothing where the program has no such
counter."""

COUNTERS = ("syzgydb_tpu_torch.utils.spans:escalate_n",)


def compute(run):
    n = run.counters.get(COUNTERS[0])
    if not run.calls or n is None:
        return None
    return n / len(run.calls)

"""scan_launches_per_call: launches of the exhaustive scan's kernels (K1,
K4, K5/K6: the program's counters below) over the traced window, per
call.  Margin-ladder escalations and radius rounds raise it."""

COUNTERS = ("syzgydb_tpu_torch.ops.scan:launches",
            "syzgydb_tpu_torch.ops.scan:surface_launches",
            "syzgydb_tpu_torch.ops.scan:free_seg_launches")


def compute(run):
    got = [run.counters.get(c) for c in COUNTERS]
    if not run.calls or any(v is None for v in got):
        return None
    return sum(got) / len(run.calls)

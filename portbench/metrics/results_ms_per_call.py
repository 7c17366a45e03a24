"""results_ms_per_call: host time inside the program's "results" spans
(syzgydb_tpu_torch.utils.spans: the margin hint and the assembly of the
fetched arrays into SearchResults, _knn_results_np or _radius_results_np,
lock included) over the traced window, per call, in ms: assembly alone,
where assemble_ms_per_call is the whole finish().  Host wall time: a
garbage collection inside a span counts.  Nothing where the program has
no such counter."""

COUNTERS = ("syzgydb_tpu_torch.utils.spans:results_ns",)


def compute(run):
    ns = run.counters.get(COUNTERS[0])
    if not run.calls or ns is None:
        return None
    return ns / len(run.calls) * 1e-6

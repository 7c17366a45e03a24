"""rerank_rows_per_query: candidate rows the rerank decodes to f32 and
scores (the program's counter syzgydb_tpu_torch.ops.scan:rerank_rows,
summed in _candidate_distances over query chunks and margin rungs) over
the traced window, per query sent.  At the default margin a query reranks
(k + 6 + 1) segments of 32 rows; a margin hint of 64 raises it to
(k + 64 + 1) x 32.  Nothing where the program has no such counter."""

COUNTERS = ("syzgydb_tpu_torch.ops.scan:rerank_rows",)


def compute(run):
    n = run.counters.get(COUNTERS[0])
    if not run.queries or n is None:
        return None
    return n / run.queries

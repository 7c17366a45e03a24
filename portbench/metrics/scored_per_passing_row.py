"""scored_per_passing_row: the (query, row) pairs the exhaustive scan
scored over the traced window (the program's counter
syzgydb_tpu_torch.ops.scan:pairs_scored, Q x N summed over every K1, K4
and K5/K6 launch) over the pairs a filtered search needs: the queries
sent times the rows whose metadata passes the traffic's predicate
(reference/filtered.passing).  1 is one scan of the passing rows alone;
a scan of every row reads rows / passing, and escalation rounds add
their share.  Nothing where the program has no such counter, or the
traffic no filter."""

from ..reference import filtered

COUNTERS = ("syzgydb_tpu_torch.ops.scan:pairs_scored",)


def compute(run):
    n = run.counters.get(COUNTERS[0])
    pred = run.traffic.get("filter")
    if not run.queries or n is None or pred is None:
        return None
    passing = len(filtered.passing(pred, run.config["rows"]))
    if passing == 0:
        return None
    return n / (run.queries * passing)

"""Traffic through Collection.search_many: one caller, `batch` kNN searches
of `k` at `precision` a call, no filter.

In a traced run the call is split where the program splits it,
search_many_async's dispatch and its finish(), with a device
synchronisation between them, so that finish() times only the fetch and
the result assembly.
"""

from __future__ import annotations

import numpy as np

from .. import compare


def setup(cell):
    from syzgydb_tpu_torch import SearchArgs

    tr = cell.traffic
    return [SearchArgs(vector=q, k=tr["k"], precision=tr["precision"])
            for q in cell.pool]


def call(state, coll, idx, spans):
    batch = [state[i] for i in idx]
    if not spans.on:
        return coll.search_many(batch)
    with spans("dispatch"):
        fin = coll.search_many_async(batch)
    with spans("sync"):
        spans.synchronize()
    with spans("finish"):
        return fin()


def check(state, cell, kept) -> dict:
    idx = np.concatenate([i for i, _ in kept])
    answers = [a for _, ans in kept for a in ans]
    return compare.knn_numbers(cell.ref, cell.pool[idx], answers,
                               cell.traffic["k"], cell.device)

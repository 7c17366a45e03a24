"""Traffic through Collection.radius_many: one caller, `batch` radius
searches at `precision` a call, no filter.  Each query's radius lies
midway between its `radius_rank`-th and next reference distance, worked
out at set-up by the reference from its own codes.
"""

from __future__ import annotations

import numpy as np

from .. import compare

# reference rows read past the rank, so that ties at the radius are kept
DEPTH = 16


def setup(cell):
    from syzgydb_tpu_torch import SearchArgs

    tr = cell.traffic
    radii, sets = compare.radius_truth(cell.ref, cell.pool,
                                       tr["radius_rank"], DEPTH, cell.device)
    args = [SearchArgs(vector=q, radius=float(r), precision=tr["precision"])
            for q, r in zip(cell.pool, radii)]
    return args, radii, sets


def call(state, coll, idx, spans):
    args = state[0]
    return coll.radius_many([args[i] for i in idx])


def check(state, cell, kept) -> dict:
    _, radii, sets = state
    idx = np.concatenate([i for i, _ in kept])
    answers = [a for _, ans in kept for a in ans]
    return compare.radius_numbers(cell.ref, cell.pool[idx], radii[idx],
                                  [sets[i] for i in idx], answers,
                                  cell.device)

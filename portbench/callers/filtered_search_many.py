"""Traffic through Collection.search_many under one metadata filter: one
caller, `batch` kNN searches of `k` at `precision` a call, every search
with the same `filter_query`, the traffic's predicate in the query
language ({"field": "i", "op": ">=", "value": 990000} is "i >= 990000").

The answers are judged against reference/filtered.py: the exact top k
among the rows whose inserted metadata passes the predicate, and
`filter_bad`, the returned ids that fail it.  In a traced run the call is
split as callers/search_many.py splits it: dispatch, a device
synchronisation, finish().
"""

from __future__ import annotations

import json

import numpy as np

from ..reference import filtered
from . import search_many


def filter_query(pred: dict) -> str:
    """The predicate as the program's query language writes it."""
    return f"{pred['field']} {pred['op']} {json.dumps(pred['value'])}"


def reference(cell) -> filtered.FilteredReference:
    """The cell's reference restricted to the rows that pass its
    traffic's predicate."""
    return filtered.FilteredReference(
        cell.ref, filtered.passing(cell.traffic["filter"], cell.ref.n))


def setup(cell):
    from syzgydb_tpu_torch import SearchArgs

    tr = cell.traffic
    query = filter_query(tr["filter"])
    return [SearchArgs(vector=q, k=tr["k"], precision=tr["precision"],
                       filter_query=query) for q in cell.pool]


def call(state, coll, idx, spans):
    return search_many.call(state, coll, idx, spans)


def check(state, cell, kept) -> dict:
    """The kept answers judged against the filtered reference, built here,
    after the measured window, so that its work stays out of setup_s."""
    fref = reference(cell)
    try:
        idx = np.concatenate([i for i, _ in kept])
        answers = [a for _, ans in kept for a in ans]
        return filtered.knn_numbers(fref, cell.pool[idx], answers,
                                    cell.traffic["k"], cell.device)
    finally:
        fref.release()

"""Exact filtered top-k in plain PyTorch: the rows whose stored metadata
passes a predicate, and the float64 nearest among them.

The predicate comes in the structured form a traffic file states,
{"field": f, "op": o, "value": v}, and is evaluated over the metadata the
benchmark inserted with each row (compare.meta_of), decoded with `json`,
so it is independent of the program's query language; a row whose
metadata lacks the field fails it.  Codes, distances and the order of
ties are exact.Reference's, over the passing rows alone.  It imports
nothing of the program.
"""

from __future__ import annotations

import copy
import functools
import json
import operator

import numpy as np
import torch

from .. import compare
from .exact import Reference

OPS = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
       "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def passing(pred: dict, n_rows: int) -> np.ndarray:
    """(P,) int64 ascending: the rows of the n_rows the benchmark inserted
    whose metadata passes `pred` (read-only)."""
    if pred["op"] not in OPS:
        raise ValueError(f"unknown operator {pred['op']!r}")
    return _passing(pred["field"], pred["op"], pred["value"], n_rows)


@functools.lru_cache(maxsize=4)
def _passing(field: str, op: str, value, n_rows: int) -> np.ndarray:
    test = OPS[op]
    keep = []
    for i in range(n_rows):
        meta = json.loads(compare.meta_of(i))
        if field in meta and test(meta[field], value):
            keep.append(i)
    out = np.array(keep, dtype=np.int64)
    out.setflags(write=False)
    return out


class FilteredReference:
    """A Reference restricted to the rows that pass a predicate: `topk`
    ranks those rows alone and returns their own row numbers, ties ordered
    by row; `n` and `pairs` are the whole reference's, so that
    compare.knn_numbers judges answers against it unchanged."""

    def __init__(self, ref: Reference, rows):
        self.full = ref
        self.rows = torch.from_numpy(np.array(rows, dtype=np.int64))
        self.n = ref.n
        self.passing = int(self.rows.numel())
        self._sub = copy.copy(ref)
        self._sub.codes = ref.codes[self.rows]
        self._sub.n = self.passing
        self._sub.release()

    def topk(self, queries, m: int, device):
        """The m nearest passing rows of each query, ascending ->
        (dist (Q, m) float64, rows (Q, m) int64), both on the CPU."""
        dist, local = self._sub.topk(queries, m, device)
        return dist, self.rows[local]

    def pairs(self, queries, rows, device) -> torch.Tensor:
        return self.full.pairs(queries, rows, device)

    def release(self) -> None:
        """Free the passing rows' device copy (the whole reference's is its
        owner's to free)."""
        self._sub.release()


def filter_bad(rows, answers) -> int:
    """Returned ids that are not among the passing `rows`."""
    ids = [a.ids for a in answers]
    if not ids:
        return 0
    return int((~np.isin(np.concatenate(ids), np.asarray(rows))).sum())


def knn_numbers(fref: FilteredReference, queries, answers, k: int,
                device) -> dict:
    """compare.knn_numbers of filtered kNN answers against the passing
    rows' top k (k cut to the rows that pass), and `filter_bad`."""
    nums = compare.knn_numbers(fref, queries, answers, min(k, fref.passing),
                               device)
    nums["filter_bad"] = filter_bad(fref.rows.numpy(), answers)
    return nums

"""The comparison that decides `correct`.

Answers come in a neutral form, one `Answer` per query: the ids, the
distances and the metadata as returned.  Doc ids are row numbers (the
benchmark inserts row i as id i with metadata {"i":i}), so the reference
judges each returned id by its own distance to that row.

Numbers (each held to a limit from the traffic file):
  shape_bad  queries whose answer has the wrong count, a repeated id or
             an id that was never stored
  meta_bad   results whose metadata is not what was inserted
  rank_gap   kNN: the widest gap, over queries and ranks, between the
             reference distance of the row returned at rank j and the
             reference's own j-th distance
  set_miss   radius: the widest distance from the radius of any row
             returned outside it or left out inside it (0 when none)
  dist_err   the widest gap between a returned distance and the
             reference distance of its row
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Answer:
    ids: np.ndarray      # int64
    dists: np.ndarray    # float64
    metas: list


def meta_of(i: int) -> bytes:
    return b'{"i":%d}' % i


def from_results(results) -> list:
    """The program's SearchResults list -> Answers."""
    return [Answer(np.array([r.id for r in res.results], dtype=np.int64),
                   np.array([r.distance for r in res.results],
                            dtype=np.float64),
                   [bytes(r.metadata) for r in res.results])
            for res in results]


def _basic(answers, n_rows: int) -> tuple[int, int]:
    shape_bad = meta_bad = 0
    for a in answers:
        if len(a.ids) != len(set(a.ids.tolist())) or len(a.ids) != len(
                a.dists) or len(a.ids) != len(a.metas) or (
                len(a.ids) and (a.ids.min() < 0 or a.ids.max() >= n_rows)):
            shape_bad += 1
            continue
        meta_bad += sum(m != meta_of(int(i)) for i, m in zip(a.ids, a.metas))
    return shape_bad, meta_bad


def _padded(answers, width: int) -> tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(answers), width), -1, dtype=np.int64)
    dists = np.full((len(answers), width), math.inf)
    for i, a in enumerate(answers):
        m = min(len(a.ids), width)
        ids[i, :m], dists[i, :m] = a.ids[:m], a.dists[:m]
    return ids, dists


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def knn_numbers(ref, queries, answers, k: int, device) -> dict:
    """kNN answers of `queries` (Q, D) against the reference's top k."""
    n = ref.n
    shape_bad, meta_bad = _basic(answers, n)
    kk = min(k, n)
    shape_bad += sum(len(a.ids) != kk for a in answers)
    true_d, _ = ref.topk(queries, kk, device)
    ids, dists = _padded(answers, kk)
    ids[(ids >= n)] = -1
    got = ref.pairs(queries, torch.from_numpy(ids), device).cpu()
    rank_gap = (got - true_d).abs().nan_to_num(math.inf)
    dist_err = (torch.from_numpy(dists) - got).abs().nan_to_num(math.inf)
    return {"shape_bad": shape_bad, "meta_bad": meta_bad,
            "rank_gap": _max(rank_gap), "dist_err": _max(dist_err)}


def radius_truth(ref, queries, rank: int, depth: int, device):
    """Radii midway between each query's rank-th and (rank+1)-th
    reference distances, and the reference's rows within them ->
    (radii (Q,) float64 numpy, sets: list of int64 arrays)."""
    d, rows = ref.topk(queries, rank + depth, device)
    radii = ((d[:, rank - 1] + d[:, rank]) / 2.0).numpy()
    inside = d <= torch.from_numpy(radii)[:, None]
    if bool(inside[:, -1].any()):
        raise RuntimeError("radius ties run past the reference's depth")
    sets = [rows[i][inside[i]].numpy() for i in range(len(radii))]
    return radii, sets


def radius_numbers(ref, queries, radii, truth_sets, answers, device) -> dict:
    """Radius answers against the reference's in-radius sets."""
    n = ref.n
    shape_bad, meta_bad = _basic(answers, n)
    width = max([len(a.ids) for a in answers] + [1])
    ids, dists = _padded(answers, width)
    ids[(ids >= n)] = -1
    got = ref.pairs(queries, torch.from_numpy(ids), device).cpu().numpy()
    r = np.asarray(radii, dtype=np.float64)[:, None]
    outside = np.where(ids >= 0, got - r, -math.inf)
    set_miss = max(0.0, float(np.nan_to_num(outside, nan=math.inf).max()))
    with np.errstate(invalid="ignore"):
        dist_err = np.where(ids >= 0, np.abs(dists - got), 0.0)
    dist_err = float(np.nan_to_num(dist_err, nan=math.inf).max())
    missed = []
    for i, a in enumerate(answers):
        left = np.setdiff1d(truth_sets[i], a.ids)
        if len(left):
            missed.append((i, left))
    if missed:
        q = torch.as_tensor(np.stack([queries[i] for i, _ in missed]))
        w = max(len(x) for _, x in missed)
        rows = np.full((len(missed), w), -1, dtype=np.int64)
        for j, (_, x) in enumerate(missed):
            rows[j, :len(x)] = x
        dd = ref.pairs(q, torch.from_numpy(rows), device).cpu().numpy()
        rr = np.array([radii[i] for i, _ in missed])[:, None]
        inside = np.where(rows >= 0, rr - dd, -math.inf)
        set_miss = max(set_miss, float(inside.max()))
    return {"shape_bad": shape_bad, "meta_bad": meta_bad,
            "set_miss": set_miss, "dist_err": dist_err}


def stored_bad(ref, get_document, ids) -> int:
    """Sampled ids whose stored vector (as the program reads it back) is
    not the reference codec's, or whose metadata is not what was
    inserted, or that cannot be read."""
    want = ref.stored(ids).numpy()
    bad = 0
    for j, i in enumerate(ids):
        try:
            doc = get_document(int(i))
        except KeyError:
            bad += 1
            continue
        vec = np.asarray(doc.vector, dtype=np.float64)
        if vec.shape != want[j].shape or not np.array_equal(vec, want[j]) \
                or bytes(doc.metadata) != meta_of(int(i)):
            bad += 1
    return bad

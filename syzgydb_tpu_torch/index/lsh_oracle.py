"""Behavioral model of the SyzgyDB Go LSH forest — a recall test oracle
(the port's copy of ``syzgydb_tpu/index/lsh_oracle.py``).

A small-scale, host-side re-expression of the Go ANN index (lshtree.go),
used only to measure recall-vs-percent-searched parity between the Go tree
search and the port's sign-sketch index (index/hamming.py).  It is on no
production path.

Semantics reproduced (with citations):
  * forest of `trees` binary hyperplane trees, leaf split threshold
    `threshold` (collection.go:292: newLSHTree(c, 100, 5))
  * split: two distinct random member vectors; plane normal is a random unit
    vector; for euclidean the offset b is the NORM of the members' midpoint
    (a quirk of lshtree.go:201-211); refuse the split when the two
    vectors are ~equal or all members land on one side (lshtree.go:196-239)
  * side/distance test: euclidean |dot-b| with right = dot-b > 0; cosine
    acos(dot/len)/pi with right = dist > 0.5 and dist = min(d, 1-d)
    (lshtree.go:59-77)
  * search: best-first over a max-priority queue seeded with all roots;
    children pushed with +dist (near side) / -dist (far side); a popped
    far-side LEAF with |priority| > radius is pruned; the search stops after
    search_k=200 consecutive non-improving point checks once at least one
    point was accepted (lshtree.go:283-351)
  * the callback contract: consider(id, radius) -> (signal, new_radius)
    with signals StopSearch/PointAccepted/PointChecked/PointIgnored
    (collection.go:19-24); the shrinking radius is the k-NN heap's current
    worst (collection.go:606-619)
"""

from __future__ import annotations

import heapq
import itertools
import math

import numpy as np

from ..utils.rng import MyRandom

STOP_SEARCH = 0
POINT_ACCEPTED = 1
POINT_CHECKED = 2
POINT_IGNORED = 3

SEARCH_K = 200  # lshtree.go:286


class _Node:
    __slots__ = ("normal", "b", "left", "right", "ids")

    def __init__(self, ids=None):
        self.normal = None
        self.b = 0.0
        self.left = None
        self.right = None
        self.ids = ids if ids is not None else []

    @property
    def is_leaf(self):
        return self.left is None


def _plane_side(metric: str, vector: np.ndarray, length: float,
                normal: np.ndarray, b: float):
    """(distance-to-plane, right?) — lshtree.go:59-77 semantics."""
    dist = float(np.dot(vector, normal)) - b
    if metric == "euclidean":
        if dist > 0:
            return dist, True
        return -dist, False
    dist = math.acos(max(-1.0, min(1.0, dist / length))) / math.pi
    if dist > 0.5:
        return 1.0 - dist, True
    return dist, False


class GoLSHForest:
    """Insert-only forest sufficient for the recall harness."""

    def __init__(self, metric: str, rng: MyRandom, threshold: int = 100,
                 trees: int = 5):
        self.metric = metric
        self.threshold = threshold
        self.roots = [_Node() for _ in range(trees)]
        self.rng = rng
        self.vectors: dict[int, np.ndarray] = {}

    def add(self, doc_id: int, vector) -> None:
        vector = np.asarray(vector, dtype=np.float64)
        self.vectors[doc_id] = vector
        length = float(np.linalg.norm(vector))
        for i, root in enumerate(self.roots):
            self.roots[i] = self._insert(root, doc_id, vector, length)

    def _insert(self, node: _Node, doc_id: int, vector, length) -> _Node:
        if node.is_leaf:
            node.ids.append(doc_id)
            if len(node.ids) > self.threshold:
                node = self._split(node)
            return node
        _, right = _plane_side(self.metric, vector, length, node.normal,
                               node.b)
        if right:
            node.right = self._insert(node.right, doc_id, vector, length)
        else:
            node.left = self._insert(node.left, doc_id, vector, length)
        return node

    def _split(self, node: _Node) -> _Node:
        n = len(node.ids)
        i1 = int(self.rng.integers(0, n))
        i2 = i1
        while i2 == i1:
            i2 = int(self.rng.integers(0, n))
        v1 = self.vectors[node.ids[i1]]
        v2 = self.vectors[node.ids[i2]]
        if np.allclose(v1, v2, atol=1e-9, rtol=0.0):
            return node  # lshtree.go:196-200: retry at the next insert
        normal = self.rng.standard_normal(v1.shape[0])
        nn = np.linalg.norm(normal)
        if nn > 0:
            normal = normal / nn
        b = 0.0
        if self.metric == "euclidean":
            mid = (v1 + v2) / 2.0
            b = float(np.linalg.norm(mid))  # quirk: norm, not projection
        left_ids, right_ids = [], []
        for doc_id in node.ids:
            v = self.vectors[doc_id]
            _, right = _plane_side(self.metric, v, float(np.linalg.norm(v)),
                                   normal, b)
            (right_ids if right else left_ids).append(doc_id)
        if not left_ids or not right_ids:
            return node  # all on one side: refuse (lshtree.go:237-239)
        out = _Node()
        out.normal, out.b = normal, b
        out.left = _Node(left_ids)
        out.right = _Node(right_ids)
        return out

    # -- search --------------------------------------------------------------

    def search(self, vector, radius: float, callback) -> None:
        """Best-first probe; callback(id, radius) -> (signal, radius)."""
        vector = np.asarray(vector, dtype=np.float64)
        length = float(np.linalg.norm(vector))
        visited: set[int] = set()
        k_counter = 0
        accepted = False
        counter = itertools.count()  # FIFO tie-break like Go's heap order
        pq: list = []
        for root in self.roots:
            heapq.heappush(pq, (-0.0, next(counter), root))
        while pq:
            neg_prio, _, node = heapq.heappop(pq)
            prio = -neg_prio
            if prio < 0 and -prio > radius and node.is_leaf:
                continue  # far side of a plane beyond the radius
            if k_counter >= SEARCH_K:
                break
            if node.is_leaf:
                for doc_id in node.ids:
                    if doc_id in visited:
                        continue
                    visited.add(doc_id)
                    signal, radius = callback(doc_id, radius)
                    if signal == STOP_SEARCH:
                        return
                    if signal == POINT_ACCEPTED:
                        k_counter = 0
                        accepted = True
                    elif signal == POINT_CHECKED and accepted:
                        k_counter += 1
            else:
                dist, right = _plane_side(self.metric, vector, length,
                                          node.normal, node.b)
                near, far = (node.right, node.left) if right else \
                    (node.left, node.right)
                heapq.heappush(pq, (-dist, next(counter), near))
                heapq.heappush(pq, (dist, next(counter), far))


def knn_via_forest(forest: GoLSHForest, query, k: int):
    """The reference's consider-closure k-NN protocol (collection.go:583-629).

    Returns (ids ascending by distance, points_searched)."""
    query = np.asarray(query, dtype=np.float64)
    heap: list = []  # max-heap via negated distance
    searched = 0

    def dist_to(v):
        if forest.metric == "euclidean":
            return float(np.linalg.norm(query - v))
        qn = np.linalg.norm(query)
        vn = np.linalg.norm(v)
        if qn == 0 or vn == 0:
            return 1.0
        cos = max(-1.0, min(1.0, float(np.dot(query, v)) / (qn * vn)))
        return math.acos(cos) / math.pi

    def consider(doc_id, radius):
        nonlocal searched
        searched += 1
        d = dist_to(forest.vectors[doc_id])
        if len(heap) <= k:
            if len(heap) < k or -heap[0][0] > d:
                heapq.heappush(heap, (-d, doc_id))
                if len(heap) > k:
                    heapq.heappop(heap)
                return POINT_ACCEPTED, -heap[0][0]
        return POINT_CHECKED, radius

    forest.search(query, math.inf, consider)
    out = sorted(((-nd, i) for nd, i in heap))
    return [i for _, i in out], searched

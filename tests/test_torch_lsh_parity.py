"""Recall parity of the port's sign-sketch index against the Go LSH forest,
with the port's own oracle (syzgydb_tpu_torch/index/lsh_oracle.py).

The cases of tests/test_lsh_parity.py on the port: the port's oracle and
the port's SignHashIndex on the same seeded corpus, compared on recall@10
at the same fraction of the database searched.  A third case holds the
port's oracle against the JAX package's: given the same MyRandom seed and
inserts, both build the same forest and return the same answers and
counts, exactly."""

import math

import numpy as np
import pytest

from syzgydb_tpu.index import lsh_oracle as jlsh
from syzgydb_tpu.utils.rng import MyRandom as JMyRandom
from syzgydb_tpu_torch.index import lsh_oracle
from syzgydb_tpu_torch.index.hamming import SignHashIndex
from syzgydb_tpu_torch.utils.rng import MyRandom


def _hamming_rank_np(qcode: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """Host Hamming distances of one packed query vs all packed rows."""
    x = np.bitwise_xor(hashes, qcode[None, :])  # (N, words) uint32
    bits = np.unpackbits(x.view(np.uint8), axis=1)
    return bits.sum(axis=1)


def _exact_topk(db, q, k):
    qn = np.linalg.norm(q)
    vn = np.linalg.norm(db, axis=1)
    cos = np.clip(db @ q / np.where(vn * qn > 0, vn * qn, 1.0), -1, 1)
    d = np.arccos(cos) / math.pi
    return np.argsort(d, kind="stable")[:k]


def _clustered(rng, n, d):
    # clustered corpus: on iid data recall@10 is meaningless
    centers = rng.standard_normal((64, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, 64, size=n)
    db = centers[assign] + 0.35 * rng.standard_normal((n, d))
    return db / np.linalg.norm(db, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d", [(4000, 16)])
def test_sketch_recall_not_worse_than_reference_lsh(n, d):
    rng = np.random.default_rng(99)
    db = _clustered(rng, n, d)

    forest = lsh_oracle.GoLSHForest("cosine", MyRandom(7))
    for i in range(n):
        forest.add(i, db[i])

    index = SignHashIndex(d, "cosine", MyRandom(7))
    hashes = index.encode_np(db)

    n_q, k = 25, 10
    queries = db[rng.integers(0, n, size=n_q)] + \
        0.2 * rng.standard_normal((n_q, d))
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    ref_recalls, ref_searched = [], []
    for q in queries:
        truth = set(_exact_topk(db, q, k).tolist())
        got, searched = lsh_oracle.knn_via_forest(forest, q, k)
        ref_recalls.append(len(truth & set(got)) / k)
        ref_searched.append(searched)

    budget = int(np.mean(ref_searched))  # same fraction of the DB touched
    our_recalls = []
    for q in queries:
        truth = set(_exact_topk(db, q, k).tolist())
        qc = index.encode_np(q)[0]
        ham = _hamming_rank_np(qc, hashes)
        cand = np.argpartition(ham, budget - 1)[:budget]
        top = cand[_exact_topk(db[cand], q, k)]
        our_recalls.append(len(truth & set(top.tolist())) / k)

    ref_recall = float(np.mean(ref_recalls))
    our_recall = float(np.mean(our_recalls))
    # at the same percent searched the sketch index must not lose to the
    # Go tree
    assert our_recall >= ref_recall - 1e-9
    assert our_recall >= 0.9


def test_oracle_forest_structure_sane():
    """The oracle behaves like a forest: splits happen, search visits a
    subset, and the point itself is found."""
    rng = np.random.default_rng(5)
    n, d = 600, 8
    db = rng.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    forest = lsh_oracle.GoLSHForest("cosine", MyRandom(3), threshold=50)
    for i in range(n):
        forest.add(i, db[i])
    assert any(not r.is_leaf for r in forest.roots)
    got, searched = lsh_oracle.knn_via_forest(forest, db[0], 5)
    assert 0 in got  # the point itself must be found
    assert searched <= n


def _planes(node, out):
    if node.is_leaf:
        out.append(("leaf", list(node.ids)))
        return out
    out.append(("plane", node.normal.tolist(), node.b))
    _planes(node.left, out)
    return _planes(node.right, out)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_oracles_agree_on_the_same_seed(metric):
    rng = np.random.default_rng(17)
    n, d = 1500, 12
    db = _clustered(rng, n, d)
    if metric == "euclidean":
        db *= rng.uniform(0.5, 2.0, (n, 1))
    db[3] = db[4]  # a duplicate pair: refused splits stay refused alike
    forests = []
    for mod, rand in ((lsh_oracle, MyRandom), (jlsh, JMyRandom)):
        f = mod.GoLSHForest(metric, rand(11), threshold=40, trees=3)
        for i in range(n):
            f.add(i, db[i])
        forests.append(f)
    port, ref = forests
    assert all(not r.is_leaf for r in port.roots)
    assert [_planes(r, []) for r in port.roots] == \
        [_planes(r, []) for r in ref.roots]
    for q in db[rng.integers(0, n, 20)] + 0.1 * rng.standard_normal((20, d)):
        assert lsh_oracle.knn_via_forest(port, q, 10) == \
            jlsh.knn_via_forest(ref, q, 10)

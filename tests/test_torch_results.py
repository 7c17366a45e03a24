"""Result assembly (Collection._knn_results_np, _radius_results_np) against
a plain per-scalar assembly, on the CPU.

The fetched arrays are made by hand: f32 distances and int64 rows as
_fetch_results returns them, int32 counts as the ANN route returns them.
Each case holds ids (some above 2**53), distances bit for bit, metadata by
identity with the column's bytes object (the REST layer's raw-splice memo
tests it with `is`) and percent_searched per query.  A removed row, whose
metadata column holds None while an in-flight search still maps to it,
reads b"".  A second test counts the tracked objects one call leaves alive,
which the collector's cost per call follows."""

import gc
import struct

import numpy as np
import pytest

import syzgydb_tpu_torch as tdb

N, DIMS, Q, K = 48, 8, 6, 10
REMOVED = 7  # the row whose metadata column reads None


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    path = tmp_path_factory.mktemp("results") / "results.dat"
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(path), distance_method=tdb.COSINE, dimension_count=DIMS,
        quantization=8, create_and_overwrite=True), device="cpu")
    rng = np.random.default_rng(3)
    ids = [i * (2**58 + 977) + 5 for i in range(N)]
    c.add_documents(ids, rng.standard_normal((N, DIMS)),
                    [b'{"i":%d}' % i for i in range(N)])
    c.remove_document(ids[REMOVED])
    assert c.columns.metadata[REMOVED] is None
    yield c
    c.close()


def _plain(coll, dist, rows, searched, n_records):
    """One query's results, one numpy scalar at a time."""
    res = []
    for d, r in zip(dist, rows):
        if np.isfinite(d):
            md = coll.columns.metadata[int(r)]
            res.append((int(coll.columns.ids[int(r)]),
                        md if md is not None else b"", float(d), int(r)))
    return res, searched / n_records * 100.0


def _plain_knn(coll, dist, rows, k, searched, n_records, cnt=None):
    return [_plain(coll, dist[qi][:k], rows[qi][:k],
                   int(cnt[qi]) if cnt is not None else searched, n_records)
            for qi in range(dist.shape[0])]


def _plain_radius(coll, dist, rows, radii, searched, n_records):
    keep = [np.isfinite(dist[i]) & (dist[i] <= r) for i, r in
            enumerate(radii)]
    return [_plain(coll, dist[i][keep[i]], rows[i][keep[i]], searched,
                   n_records) for i in range(len(radii))]


def _arrays(rng, width, rows_from=None):
    dist = np.sort(rng.uniform(0.0, 2.0, (Q, width)), axis=1)
    dist = dist.astype(np.float32)
    rows = rng.integers(0, N, (Q, width)) if rows_from is None \
        else rng.choice(rows_from, (Q, width))
    return dist, rows.astype(np.int64)


def _knn_finite(coll, rng):
    dist, rows = _arrays(rng, K + 4)  # wider than k: the tail is cut
    return (coll._knn_results_np(dist, rows, K, 40, N),
            _plain_knn(coll, dist, rows, K, 40, N))


def _knn_inf_tail(coll, rng):
    # k above the live rows: inf pads each query's tail, rows 0 under it
    dist, rows = _arrays(rng, 8)
    for qi in range(Q):
        dist[qi, 8 - qi:] = np.inf
        rows[qi, 8 - qi:] = 0
    out = coll._knn_results_np(dist, rows, 12, 8, N)
    assert [len(r.results) for r in out] == [8 - qi for qi in range(Q)]
    return out, _plain_knn(coll, dist, rows, 12, 8, N)


def _ann_counts(coll, rng):
    dist, rows = _arrays(rng, K)
    cnt = rng.integers(0, N, Q).astype(np.int32)
    return (coll._knn_results_np(dist, rows, K, 16, N, cnt),
            _plain_knn(coll, dist, rows, K, 16, N, cnt))


def _knn_metadata_none(coll, rng):
    dist, rows = _arrays(rng, K, rows_from=[REMOVED, 3, 40])
    rows[:, 0] = REMOVED
    return (coll._knn_results_np(dist, rows, K, N, N),
            _plain_knn(coll, dist, rows, K, N, N))


def _radius(coll, rng, radii):
    dist, rows = _arrays(rng, 16)
    dist[:, 12:] = np.inf
    out = [coll._radius_results_np(dist[i], rows[i], r, 30, N)
           for i, r in enumerate(radii)]
    return out, _plain_radius(coll, dist, rows, radii, 30, N)


def _radius_some(coll, rng):
    out, want = _radius(coll, rng, [0.3, 0.9, 1.4, 2.5, 1.0, 0.7])
    assert all(0 < len(r.results) for r in out[1:4])
    return out, want


def _radius_none(coll, rng):
    out, want = _radius(coll, rng, [-1.0] * Q)
    assert all(len(r.results) == 0 for r in out)
    return out, want


CASES = {"knn_finite": _knn_finite, "knn_inf_tail": _knn_inf_tail,
         "ann_counts": _ann_counts, "knn_metadata_none": _knn_metadata_none,
         "radius_some": _radius_some, "radius_none": _radius_none}


def _bits(x):
    return struct.pack("<d", x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_assembly_matches_plain(coll, case):
    out, want = CASES[case](coll, np.random.default_rng(sorted(CASES)
                                                        .index(case)))
    assert len(out) == len(want)
    for got, (res, pct) in zip(out, want):
        assert got.percent_searched == pct
        assert len(got.results) == len(res)
        for r, (doc_id, md, d, row) in zip(got.results, res):
            assert type(r.id) is int and r.id == doc_id
            assert type(r.distance) is float and _bits(r.distance) == _bits(d)
            if row == REMOVED:
                assert r.metadata == b""
            else:
                assert r.metadata is coll.columns.metadata[row]


def test_knn_assembly_tracked_objects(coll):
    """One call leaves alive at most one tracked object per result, per
    query's SearchResults and per query's list, and a few more."""
    q, k = 64, K
    rng = np.random.default_rng(5)
    dist, rows = _arrays(rng, k)
    dist, rows = np.resize(dist, (q, k)), np.resize(rows, (q, k))
    coll._knn_results_np(dist, rows, k, N, N)  # warm any lazy state
    gc.collect()
    gc.disable()
    try:
        before = len(gc.get_objects())
        out = coll._knn_results_np(dist, rows, k, N, N)
        added = len(gc.get_objects()) - before
    finally:
        gc.enable()
    assert sum(len(r.results) for r in out) == q * k
    assert added <= q * (k + 2) + 8, added

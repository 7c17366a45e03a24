"""The port's mesh layer (syzgydb_tpu_torch/parallel/, Collection.use_mesh,
the capacity preflight under a mesh, and the embedder's DP x TP train step)
against the JAX package's on the CPU: the counterparts of
tests/test_parallel.py and tests/test_embedder.py::
test_sharded_train_step_on_mesh.

The JAX side runs on the first data * feature of the 8 virtual devices
(tests/conftest.py); the port's side on a single-process mesh of the same
shape whose devices are all the CPU (make_mesh(..., devices=[cpu] * n)).
Both see the same numpy data from seeds.

Tolerances:
- sharded distances against the JAX package's and the port's single-device
  ones: within 1e-5 relative and absolute (tests/test_parallel.py's own
  atol; the f32 accumulation cushion surface_accum_eps(32) is ~2.4e-5 in
  surrogate units, and the measured gaps are ~5e-7);
- the sharded train step: the loss within 2e-6 relative and every
  parameter after one SGD step at lr 1e-2 within 1e-6 of the JAX package's
  step on its sharded arrays (tests/test_torch_train.py's f32 bounds) and
  of the port's unsharded train_step.

The JAX tests of the TPU layouts have no counterpart, as the port has no
such layouts (ROADMAP: the port keeps the outputs, not the TPU layouts):
test_parallel.py::test_sharded_exact_ilv_kernel_parity,
::test_mesh_ilv_memory_gate_is_per_shard,
::test_mesh_exact_interpret_runs_ilv_kernel and
::test_sharded_ann_kernel_path_parity (the port's sketch route always runs
its Hamming kernel's wrapper), and test_lane_rerank.py's mesh lane-slab
cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.index.hamming import SignHashIndex as JIndex
from syzgydb_tpu.models import embedder as je
from syzgydb_tpu.ops import distance as jdist
from syzgydb_tpu.ops import quantize as jqz
from syzgydb_tpu.parallel import mesh as jmesh
from syzgydb_tpu.parallel import search as jsearch
from syzgydb_tpu_torch.core import capacity as tcap
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.index.hamming import SignHashIndex as TIndex
from syzgydb_tpu_torch.models import embedder as te
from syzgydb_tpu_torch.ops import scan as tscan
from syzgydb_tpu_torch.parallel import mesh as tmesh
from syzgydb_tpu_torch.parallel import search as tsearch

CPU = torch.device("cpu")
RTOL = ATOL = 1e-5
LOSS_RTOL, SGD_ATOL = 2e-6, 1e-6
SHAPES = [(8, 1), (4, 2), (2, 4), (4, 1)]


def _meshes(data, feature):
    n = data * feature
    return (jmesh.make_mesh(jmesh.MeshConfig(data=data, feature=feature),
                            jax.devices()[:n]),
            tmesh.make_mesh(tmesh.MeshConfig(data=data, feature=feature),
                            [CPU] * n))


def _setup(rng, n=512, d=32, bits=8, nq=4):
    db = rng.uniform(-1, 1, size=(n, d))
    codes = jqz.codes_to_device_repr(db, bits)
    norms = jdist.db_row_stats(codes, bits, d)
    valid = np.ones(n, dtype=bool)
    queries = np.float32(rng.uniform(-1, 1, size=(nq, d)))
    return db, codes, norms, valid, queries


def _port_exact(mesh, queries, codes, norms, valid, bits, metric, k,
                **kw):
    st = tmesh.place(mesh, codes, norms, valid, bits=bits)
    return tsearch.sharded_exact_topk(
        mesh, torch.from_numpy(queries), st["codes"], st["norms"],
        st["valid"], bits=bits, metric=metric, k=k, **kw)


def _single(queries, codes, norms, valid, bits, metric, k):
    """The port's single-device answer with every segment reranked."""
    args = [torch.from_numpy(np.asarray(a, dtype=np.float32)
                             if bits == 64 else a)
            for a in (queries, codes, norms, valid)]
    return tscan.fused_scan_topk(*args, bits=bits, metric=metric, k=k,
                                 tie_margin=1 << 30)


# -- the mesh -----------------------------------------------------------------


def test_mesh_shape_lead_and_splits():
    m = tmesh.make_mesh(tmesh.MeshConfig(data=4, feature=2), [CPU] * 8)
    assert m.shape == {"data": 4, "feature": 2}
    assert m.devices.shape == (4, 2) and m.lead == CPU
    assert tmesh.make_mesh(devices=[CPU] * 8).shape == {"data": 8,
                                                        "feature": 1}
    assert tmesh.pad_rows(1000, m, 32) == 1024
    assert tmesh.pad_cols(30, m) == 30 and tmesh.pad_cols(31, m) == 32
    assert tmesh.col_range(m, 32, 1) == (16, 32)
    with pytest.raises(ValueError, match="columns"):
        tmesh.col_range(m, 31, 0)


def test_make_mesh_feature_exceeding_devices_raises():
    """feature > device count must raise, not build an empty mesh."""
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(tmesh.MeshConfig(feature=16), [CPU] * 8)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(tmesh.MeshConfig(data=4, feature=4), [CPU] * 8)


def test_place_pads_the_last_shard_with_invalid_rows(rng):
    _, codes, norms, valid, _ = _setup(rng, n=200, bits=8)
    m = tmesh.make_mesh(tmesh.MeshConfig(data=3), [CPU] * 3)
    st = tmesh.place(m, codes, norms, valid, bits=8)
    assert st["n_local"] == 96  # 200 / 3 rounded up to whole segments
    assert [v.shape[0] for v in st["valid"]] == [96] * 3
    assert int(sum(v.sum() for v in st["valid"])) == 200
    assert not st["valid"][2][200 - 192:].any()
    assert torch.equal(st["codes"][1][0], torch.from_numpy(codes[96:192]))


# -- sharded_exact_topk -------------------------------------------------------


@pytest.mark.parametrize("data,feature", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_sharded_exact_matches_jax_and_single_device(rng, data, feature,
                                                     bits):
    jm, tm = _meshes(data, feature)
    _, codes, norms, valid, queries = _setup(rng, bits=bits)
    k = 10
    jd, ji = jsearch.sharded_exact_topk(
        jm, jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=bits, metric="euclidean", k=k, exact=True)
    assert tsearch.fused_ok(k, 512 // data)  # the fused branch
    td, ti, ok = _port_exact(tm, queries, codes, norms, valid, bits,
                             "euclidean", k, with_ties=True)
    sd, si = _single(queries, codes, norms, valid, bits, "euclidean", k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(td.numpy(), sd.numpy(), rtol=RTOL, atol=ATOL)
    for q in range(queries.shape[0]):
        assert set(ti[q].tolist()) == set(np.asarray(ji)[q].tolist())
    if feature == 1:
        # every shard runs the single device's arithmetic on its rows
        assert torch.equal(ti, si) and torch.equal(td, sd)
    assert ok.shape == (queries.shape[0],) and ok.dtype == torch.int32


@pytest.mark.parametrize("feature", [1, 2])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_large_k_takes_the_non_fused_branch(rng, feature, metric,
                                            monkeypatch):
    """Past k = 128 each shard selects from the whole surface: K4's
    surface_topk at feature 1 (with its flag), an exact top-k at feature
    2; the merged rows are the single device's."""
    calls = []
    real = tscan.surface_topk
    monkeypatch.setattr(tscan, "surface_topk",
                        lambda *a, **kw: calls.append(kw["margin"]) or
                        real(*a, **kw))
    _, tm = _meshes(4, feature)
    _, codes, norms, valid, queries = _setup(rng, n=1024, bits=8)
    k = 200
    assert not tsearch.fused_ok(k, 256)
    td, ti, ok = _port_exact(tm, queries, codes, norms, valid, 8, metric, k,
                             with_ties=True)
    sd, si = _single(queries, codes, norms, valid, 8, metric, k)
    assert len(calls) == (4 if feature == 1 else 0)
    assert all(m == tsearch.DEFAULT_MESH_SEG_MARGIN * 32 for m in calls)
    assert bool(ok.all())
    np.testing.assert_allclose(td.numpy(), sd.numpy(), rtol=RTOL, atol=ATOL)
    for q in range(queries.shape[0]):
        assert set(ti[q].tolist()) == set(si[q].tolist())


@pytest.mark.parametrize("data,feature", [(4, 1), (2, 2)])
def test_proven_flags_imply_the_exact_topk(rng, data, feature):
    """At every margin, a query whose flag is 1 has the exact f32 top-k."""
    _, tm = _meshes(data, feature)
    _, codes, norms, valid, queries = _setup(rng, n=4096, bits=8, nq=16)
    valid[::5] = False
    k = 10
    sd, si = _single(queries, codes, norms, valid, 8, "cosine", k)
    proven = 0
    for margin in (0, 1, 2, 8):
        td, ti, ok = _port_exact(tm, queries, codes, norms, valid, 8,
                                 "cosine", k, seg_margin=margin,
                                 with_ties=True)
        for q in np.flatnonzero(ok.numpy()):
            proven += 1
            assert set(ti[q].tolist()) == set(si[q].tolist()), (margin, q)
            np.testing.assert_allclose(td[q].numpy(), sd[q].numpy(),
                                       rtol=RTOL, atol=ATOL)
    assert proven > 0


def _tie_corpus():
    """tests/test_provable_high.py's adversarial corpus (300 segments whose
    minima differ at the 1e-6 level; the true winners sit at the highest
    segment indices, inside one data shard of an 8-shard mesh)."""
    n, d, n_ties, lo = 65536, 16, 300, 600
    rng = np.random.default_rng(9)
    db = rng.standard_normal((n, d))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db[:, 0] = np.abs(db[:, 0]) * 0.2
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    for i in range(n_ties):
        row = (lo + i) * 32
        cos = 0.7 + i * 1e-6
        db[row] = 0.0
        db[row, 0] = cos
        db[row, 1] = np.sqrt(1.0 - cos * cos)
    q = np.zeros(d)
    q[0] = 1.0
    want = [(lo + n_ties - 1 - i) * 32 for i in range(10)]
    return db, q, want


@pytest.mark.parametrize("feature", [1, 2])
def test_near_tie_must_escalate(feature):
    """On the tie corpus the default margin cannot prove the top-10: the
    flag is 0, and the Collection's margin ladder proves it exactly."""
    db, q, want = _tie_corpus()
    codes = jqz.codes_to_device_repr(db, 32)
    norms = jdist.db_row_stats(codes, 32, 16)
    valid = np.ones(len(db), dtype=bool)
    _, tm = _meshes(8 // feature, feature)
    queries = np.float32(q[None, :])
    _, _, ok = _port_exact(tm, queries, codes, norms, valid, 32, "cosine",
                           10, with_ties=True)
    assert int(ok[0]) == 0
    for margin in (*tcoll.Collection._MARGIN_LADDER, 1 << 30):
        _, rows, ok = _port_exact(tm, queries, codes, norms, valid, 32,
                                  "cosine", 10, seg_margin=margin,
                                  with_ties=True)
        if int(ok[0]):
            break
    assert int(ok[0]) and rows[0].tolist() == want


def test_shards_without_valid_rows_prove_at_the_first_rung(rng):
    """A filter that leaves whole shards (and most segments) without a
    valid row: every shard's flag is 1 at the default margin, as the
    single device's is, with the exact top-k; the reference's flag would
    be 0 there and climb the ladder to every segment."""
    _, tm = _meshes(4, 1)
    _, codes, norms, valid, queries = _setup(rng, n=8192, bits=8)
    valid[:] = False
    valid[100:260] = True  # 160 rows in 6 segments of shard 0
    k = 10
    td, ti, ok = _port_exact(tm, queries, codes, norms, valid, 8, "cosine",
                             k, with_ties=True)
    sd, si, sok = tscan.fused_scan_topk(
        *[torch.from_numpy(a) for a in (queries, codes, norms, valid)],
        bits=8, metric="cosine", k=k, with_ties=True)
    assert bool(ok.all()) and bool(sok.all())
    assert torch.equal(ti, si) and torch.equal(td, sd)
    assert ((ti >= 100) & (ti < 260)).all()


def test_each_shard_flag_takes_its_routes_dq_rel(rng, monkeypatch):
    """Every shard's flag bounds the route that computed its surface: the
    dq_rel its K1 launch returned reaches its surface_delta (stubbed here
    as the int8 route would return it)."""
    _, tm = _meshes(4, 1)
    _, codes, norms, valid, queries = _setup(rng, n=4096, bits=8)
    fake = [torch.full((4,), 1e-7 * (i + 1)) for i in range(4)]
    shard = iter(range(4))
    real_min, real_delta = tscan._segment_min, tscan.surface_delta
    seen = []

    def seg_min(*a, **kw):
        return real_min(*a, **kw)[0], fake[next(shard)]

    def delta(*a, dq_rel=None, **kw):
        seen.append(dq_rel)
        return real_delta(*a, dq_rel=dq_rel, **kw)

    monkeypatch.setattr(tscan, "_segment_min", seg_min)
    monkeypatch.setattr(tscan, "surface_delta", delta)
    _port_exact(tm, queries, codes, norms, valid, 8, "cosine", 5,
                with_ties=True)
    assert len(seen) == 4 and all(s is f for s, f in zip(seen, fake))


def test_invalid_rows_never_returned(rng):
    for data, feature in ((8, 1), (4, 2)):
        _, tm = _meshes(data, feature)
        _, codes, norms, valid, queries = _setup(rng, n=128, bits=32)
        valid[::2] = False
        _, rows = _port_exact(tm, queries, codes, norms, valid, 32,
                              "euclidean", 20)
        assert all(r % 2 == 1 for r in rows.numpy().ravel())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_scores_full_matrix(rng, metric):
    jm, tm = _meshes(4, 2)
    _, codes, norms, valid, queries = _setup(rng, n=256, bits=32)
    valid[7] = False
    want = np.asarray(jsearch.sharded_scores(
        jm, jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(norms),
        jnp.asarray(valid), bits=32, metric=metric, exact=True))
    st = tmesh.place(tm, codes, norms, valid, bits=32)
    got = tsearch.sharded_scores(tm, torch.from_numpy(queries), st["codes"],
                                 st["norms"], st["valid"], bits=32,
                                 metric=metric).numpy()
    assert got.shape == (4, 256) and np.isinf(got[:, 7]).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- sharded_ann_topk ---------------------------------------------------------


def _ann_inputs(rng, n=2048, d=32, bits=8):
    db, codes, norms, valid, queries = _setup(rng, n=n, d=d, bits=bits)
    jidx = JIndex(d, "euclidean", jdb.MyRandom(99))
    jidx.calibrate(db[:1024])
    tidx = TIndex(d, "euclidean", tdb.MyRandom(99))
    tidx.calibrate(db[:1024])
    hashes = jidx.encode_batch(np.float32(db))
    assert np.array_equal(tidx.encode_np(np.float32(db)), hashes)
    return db, codes, norms, valid, queries, hashes, jidx.encode_np(queries)


@pytest.mark.parametrize("data,feature", [(8, 1), (4, 2)])
def test_sharded_ann_recall_and_nscored(rng, data, feature):
    jm, tm = _meshes(data, feature)
    k, budget = 10, 64
    db, codes, norms, valid, queries, hashes, qcodes = _ann_inputs(rng)
    valid[::3] = False
    jd, jr, jn = jsearch.sharded_ann_topk(
        jm, jnp.asarray(qcodes), jnp.asarray(queries), jnp.asarray(codes),
        jnp.asarray(norms), jnp.asarray(hashes), jnp.asarray(valid),
        bits=8, metric="euclidean", k=k, local_budget=budget,
        words=5, with_counts=True)
    st = tmesh.place(tm, codes, norms, valid, hashes, bits=8)
    td, tr, tn = tsearch.sharded_ann_topk(
        tm, torch.from_numpy(qcodes.view(np.int32)),
        torch.from_numpy(queries), st["codes"], st["norms"], st["hashes"],
        st["valid"], bits=8, metric="euclidean", k=k, local_budget=budget,
        with_counts=True)
    sd, si = _single(queries, codes, norms, valid, 8, "euclidean", k)
    rec = [len(set(tr[q].tolist()) & set(si[q].tolist())) / k
           for q in range(queries.shape[0])]
    assert np.mean(rec) >= 0.6, rec
    # nscored: the valid candidates of every shard, as the JAX package
    # counts them (each shard holds more than `budget` valid rows)
    assert tn.tolist() == np.asarray(jn).tolist() == [data * budget] * 4
    assert all(r % 3 != 0 for r in tr.numpy().ravel())
    assert (np.diff(td.numpy(), axis=1) >= 0).all()
    # the same candidates up to the Hamming ties at each budget's edge
    for q in range(queries.shape[0]):
        assert len(set(tr[q].tolist()) & set(np.asarray(jr)[q].tolist())) \
            >= k - 2


@pytest.mark.parametrize("fn", ["exact", "scores", "ann"])
def test_packed4_alignment_guard(rng, fn):
    """4-bit feature shards need dim % (2 * feature) == 0."""
    _, tm = _meshes(2, 2)
    d = 18
    db, codes, norms, valid, queries = _setup(rng, n=512, d=d, bits=4)
    q = torch.from_numpy(queries)
    with pytest.raises(ValueError, match="4-bit"):
        if fn == "exact":
            tsearch.sharded_exact_topk(tm, q, None, [valid], [valid],
                                       bits=4, metric="euclidean", k=5)
        elif fn == "scores":
            tsearch.sharded_scores(tm, q, None, None, None, bits=4,
                                   metric="euclidean")
        else:
            tsearch.sharded_ann_topk(tm, None, q, None, None, None, None,
                                     bits=4, metric="euclidean", k=5,
                                     local_budget=64)


def test_wide_code_reranks_never_ride_tf32(rng, monkeypatch):
    """Every fp32 product of the mesh paths (feature partials, reranks)
    runs with TF32 off, whatever the caller set."""
    seen = []
    real_matmul, real_einsum = torch.Tensor.__matmul__, torch.einsum

    def matmul(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(a, b)

    def einsum(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*args)

    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(torch, "einsum", einsum)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for bits in (16, 32):
        db, codes, norms, valid, queries, hashes, qcodes = _ann_inputs(
            rng, n=512, bits=bits)
        for data, feature in ((4, 1), (2, 2)):
            _, tm = _meshes(data, feature)
            st = tmesh.place(tm, codes, norms, valid, hashes, bits=bits)
            q = torch.from_numpy(queries)
            tsearch.sharded_ann_topk(
                tm, torch.from_numpy(qcodes.view(np.int32)), q, st["codes"],
                st["norms"], st["hashes"], st["valid"], bits=bits,
                metric="cosine", k=5, local_budget=32)
            for k in (5, 200):
                tsearch.sharded_exact_topk(tm, q, st["codes"], st["norms"],
                                           st["valid"], bits=bits,
                                           metric="euclidean", k=k)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


# -- Collection on a mesh -----------------------------------------------------


def _coll(pkg, path, n, dims, bits, metric, rng, **kw):
    c = pkg.Collection(pkg.CollectionOptions(
        name=str(path), distance_method=metric, dimension_count=dims,
        quantization=bits, create_and_overwrite=True, index_seed=3),
        **({"device": "cpu"} if pkg is tdb else {}))
    vecs = kw.get("vecs")
    if vecs is None:
        vecs = rng.standard_normal((n, dims))
    c.add_documents(list(range(n)), vecs, [b'{"i":%d}' % i for i in range(n)])
    return c, vecs


def test_collection_on_mesh_matches_single_device(tmp_path, rng):
    """Collection.use_mesh in both packages: sharded searches agree with
    the single device, and the two packages' sharded answers agree."""
    vecs = rng.standard_normal((3000, 16))
    q = rng.standard_normal(16)
    out = {}
    for pkg, mesh in ((jdb, jmesh.make_mesh(jmesh.MeshConfig(data=8))),
                      (tdb, tmesh.make_mesh(tmesh.MeshConfig(data=8),
                                            [CPU] * 8))):
        c, _ = _coll(pkg, tmp_path / f"{pkg.__name__}.dat", 3000, 16, 8,
                     pkg.COSINE, rng, vecs=vecs)

        def run():
            s = c.search
            return {
                "exact": s(pkg.SearchArgs(vector=q, k=10, precision="exact")),
                "high": s(pkg.SearchArgs(vector=q, k=10, precision="high")),
                "medium": s(pkg.SearchArgs(vector=q, k=10)),
                "radius": s(pkg.SearchArgs(vector=q, radius=0.4,
                                           precision="exact")),
                "filtered": s(pkg.SearchArgs(vector=q, k=10, precision="high",
                                             filter_query="i < 1000"))}

        single = run()
        c.use_mesh(mesh)
        sharded = run()
        for name in ("exact", "high", "filtered"):
            assert [r.id for r in sharded[name].results] == \
                [r.id for r in single[name].results], name
        assert {r.id for r in sharded["radius"].results} == \
            {r.id for r in single["radius"].results}
        assert all(r.id < 1000 for r in sharded["filtered"].results)
        # medium partitions the sketch budget per shard
        overlap = len({r.id for r in sharded["medium"].results} &
                      {r.id for r in single["medium"].results})
        assert overlap >= 8, overlap
        out[pkg] = sharded
        if pkg is tdb:
            assert c._mesh is mesh and len(c._dev["codes"]) == 8
            c.use_mesh(None)
            assert [r.id for r in c.search(pkg.SearchArgs(
                vector=q, k=10, precision="high")).results] == \
                [r.id for r in single["high"].results]
            assert c._mesh is None
        c.close()
    for name in ("exact", "high", "filtered"):
        np.testing.assert_allclose(
            [r.distance for r in out[tdb][name].results],
            [r.distance for r in out[jdb][name].results], rtol=RTOL,
            atol=ATOL)
        assert [r.id for r in out[tdb][name].results] == \
            [r.id for r in out[jdb][name].results], name


def test_use_mesh_checks_its_mesh(tmp_path, rng):
    c, _ = _coll(tdb, tmp_path / "c.dat", 100, 8, 8, tdb.COSINE, rng)
    with pytest.raises(ValueError, match="feature"):
        c.use_mesh(tmesh.make_mesh(tmesh.MeshConfig(data=2, feature=2),
                                   [CPU] * 4))
    c.close()


def test_escalation_on_tie_corpus_under_a_mesh(tmp_path):
    """The tie corpus on an 8-shard mesh in both packages: the flag fails
    at the mesh's default margin and the Collection escalates to the exact
    top-10."""
    db, q, want = _tie_corpus()
    for pkg, mesh in ((jdb, jmesh.make_mesh(jmesh.MeshConfig(data=8))),
                      (tdb, tmesh.make_mesh(tmesh.MeshConfig(data=8),
                                            [CPU] * 8))):
        c, _ = _coll(pkg, tmp_path / f"{pkg.__name__}.dat", len(db), 16, 32,
                     pkg.COSINE, None, vecs=db)
        c.use_mesh(mesh)
        res = c.search(pkg.SearchArgs(vector=q, k=10, precision="high"))
        assert [r.id for r in res.results] == want
        c.close()


@pytest.mark.parametrize("precision", ["exact", "high"])
def test_radius_escalation_returns_all(tmp_path, rng, precision):
    """A radius search on a mesh returns every in-radius row past the first
    1024-row bound (high: K4's branch on every shard, then k x 4)."""
    vecs = rng.uniform(-0.01, 0.01, size=(2000, 4))
    for pkg, mesh in ((jdb, jmesh.make_mesh(jmesh.MeshConfig(data=8))),
                      (tdb, tmesh.make_mesh(tmesh.MeshConfig(data=8),
                                            [CPU] * 8))):
        c, _ = _coll(pkg, tmp_path / f"{pkg.__name__}.dat", 2000, 4, 32,
                     pkg.EUCLIDEAN, rng, vecs=vecs)
        c.use_mesh(mesh)
        res = c.search(pkg.SearchArgs(vector=[0.0] * 4, radius=1.0,
                                      precision=precision))
        assert len(res.results) == 2000
        c.close()


def test_mesh_incremental_scatter_sync(tmp_path, rng, monkeypatch):
    """Under a mesh, small mutation batches are scattered into their shards
    (never a full re-placement) and searches stay right."""
    from syzgydb_tpu_torch.ops import quantize as tqz

    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    n = 1000  # capacity 1024: the inserts below stay within it
    c, vecs = _coll(tdb, tmp_path / "ms.dat", n, 8, 8, tdb.EUCLIDEAN, rng,
                    vecs=rng.uniform(-1, 1, size=(n, 8)))
    live = dict(zip(range(n), vecs))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(data=8), [CPU] * 8)
    c.use_mesh(mesh)
    q = rng.uniform(-1, 1, size=8)
    c.search(tdb.SearchArgs(vector=q, k=5, precision="exact"))
    assert c.sync_stats["full"] == 1
    next_id = n
    for step in range(6):
        if step % 3 == 2:
            for doc_id in list(live)[:3]:
                c.remove_document(doc_id)
                del live[doc_id]
        else:
            add = rng.uniform(-1, 1, size=(3, 8))
            ids = list(range(next_id, next_id + 3))
            next_id += 3
            c.add_documents(ids, add, [b"{}"] * 3)
            live.update(zip(ids, add))
        got = [r.id for r in c.search(
            tdb.SearchArgs(vector=q, k=5, precision="exact")).results]
        ids_arr = np.array(list(live.keys()))
        seen = tqz.quantization_roundtrip(np.array(list(live.values())), 8)
        d = np.sqrt(((seen - q) ** 2).sum(axis=1))
        assert set(got) == set(ids_arr[np.argsort(d, kind="stable")[:5]]
                               .tolist()), f"step {step}"
        high = [r.id for r in c.search(
            tdb.SearchArgs(vector=q, k=5, precision="high")).results]
        assert high == got
    assert c.sync_stats == {"full": 1, "scatter": 6}
    # the scattered columns are still one block per shard, on its device
    assert [t.shape[0] for t in c._dev["valid"]] == [128] * 8
    assert int(sum(int(v.sum()) for v in c._dev["valid"])) == len(live)


def test_capacity_preflight_divides_by_data_shards(tmp_path, rng,
                                                   monkeypatch):
    """Under a mesh the device peak divides over the data shards: an
    ingest a single card refuses fits four distinct cards (a mesh is built
    on named CUDA devices; no placement happens before a search), and a
    device that holds several shards carries each of them."""
    monkeypatch.setattr(tcap, "host_available", lambda: 1 << 40)
    c, _ = _coll(tdb, tmp_path / "cap.dat", 10, 8, 8, tdb.COSINE, rng)
    n_new = 40_000
    cap = tcap.grown_capacity(c.columns.capacity, 10 + n_new)
    peak = tcap.estimate(cap, 8, 8, c.columns.hash_words, 2)["device_peak"]
    budget = int(peak / 2 / tcap._DEVICE_MARGIN)  # fits half the peak
    monkeypatch.setattr(tcap, "device_budget", lambda dev: budget)
    cards = tmesh.make_mesh(tmesh.MeshConfig(data=4),
                            [torch.device("cuda", i) for i in range(4)])
    one_card = tmesh.make_mesh(tmesh.MeshConfig(data=4),
                               [torch.device("cuda", 0)] * 4)
    rows = rng.standard_normal((n_new, 8))
    ids = list(range(100, 100 + n_new))
    for mesh in (None, one_card):
        c.use_mesh(mesh)
        with pytest.raises(tcap.CapacityError, match="use_mesh"):
            c.add_documents(ids, rows, [b"{}"] * n_new)
        assert c.get_document_count() == 10
    c.use_mesh(cards)
    c.add_documents(ids, rows, [b"{}"] * n_new)
    assert c.get_document_count() == 10 + n_new
    c.use_mesh(None)
    c.close()


# -- the embedder's DP x TP train step ----------------------------------------


SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128,
             max_len=32)


def _tokens(cfg, seed, n=8):
    from syzgydb_tpu_torch.models import train_synthetic as ts
    from syzgydb_tpu_torch.models.tokenizer import HashingTokenizer

    topics, filler = ts.make_vocab()
    r = np.random.default_rng(seed)
    picks = r.permutation(ts.N_TOPICS)[:n]
    tok = HashingTokenizer(cfg.vocab_size, cfg.max_len)
    return (*tok.batch_encode([ts.sample_doc(r, topics[t], filler)
                               for t in picks]),
            *tok.batch_encode([ts.sample_doc(r, topics[t], filler)
                               for t in picks]))


def test_embedder_shardings_split_the_tp_layers():
    cfg = te.EmbedderConfig(dtype="float32", **SMALL)
    model = te.Encoder(cfg)
    m = tmesh.make_mesh(tmesh.MeshConfig(data=4, feature=2), [CPU] * 8)
    sh = te.embedder_shardings(m, model)
    split = {n: s for n, s in sh.items() if s is not None}
    assert set(split) == {f"blocks.{b}.{p}" for b in range(2) for p in (
        "fc1.weight", "fc1.bias", "fc2.weight", "attn.qkv.weight",
        "attn.qkv.bias", "attn.out.weight")}
    assert split["blocks.0.fc2.weight"] == te.Split(1)
    assert split["blocks.0.attn.qkv.weight"] == te.Split(0, 3)
    # the q, k and v thirds each give a shard the same heads
    w = torch.arange(12.0)[:, None]
    blk = te.Split(0, 3).take(w, 1, 2)
    assert blk[:, 0].tolist() == [2, 3, 6, 7, 10, 11]
    assert torch.equal(te.Split(0, 3).join(
        [te.Split(0, 3).take(w, j, 2) for j in range(2)]), w)
    with pytest.raises(ValueError, match="split"):
        te.embedder_shardings(tmesh.make_mesh(
            tmesh.MeshConfig(data=1, feature=8), [CPU] * 8), model)


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_train_step_sharded_matches_jax_and_unsharded(arch):
    """DP x TP on 4 x 2: the port's sharded step against the JAX
    train_step on its sharded arrays (embedder_shardings, batch over
    'data') and against the port's unsharded train_step."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    eps = 1e-12 if arch == "bert" else 1e-6
    jcfg = je.EmbedderConfig(dtype=jnp.float32, arch=arch, ln_eps=eps,
                             **SMALL)
    tcfg = te.EmbedderConfig(dtype="float32", arch=arch, ln_eps=eps, **SMALL)
    j = je.TextEmbedder(jcfg, seed=1)
    host = jax.tree.map(np.asarray, j.params)
    jm, tm = _meshes(4, 2)
    params = jax.device_put(jax.tree.map(jnp.array, host),
                            je.embedder_shardings(jm, host))
    batch = _tokens(tcfg, seed=6)
    dp = NamedSharding(jm, P("data", None))
    new, jloss = je.train_step(params, None, j.model, *(
        jax.device_put(jnp.asarray(x), dp) for x in batch), lr=1e-2)
    want = te.state_dict_from_flax(jax.tree.map(np.asarray, new), tcfg)

    def port_model():
        t = te.TextEmbedder(tcfg, seed=5, device="cpu")
        t.load_state_dict(te.state_dict_from_flax(host, tcfg))
        return t.train_model()

    sharded = te.ShardedEncoder(tm, port_model())
    sloss = te.train_step_sharded(tm, sharded, *batch, lr=1e-2)
    plain = port_model()
    ploss = te.train_step(plain, *batch, lr=1e-2)
    np.testing.assert_allclose(float(sloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(sloss), float(ploss), rtol=LOSS_RTOL)
    got = sharded.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=SGD_ATOL, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(),
                                   plain.state_dict()[name].numpy(), rtol=0,
                                   atol=SGD_ATOL, err_msg=name)
    # the parameters keep their splits, and every data row's replica is
    # the same after the step
    for name, sp in sharded.splits.items():
        blocks = sharded.replicas(name)
        assert len(blocks) == (1 if sp is None else 2)
        for reps in blocks:
            assert len(reps) == 4
            assert all(torch.equal(r, reps[0]) for r in reps)
    assert not np.array_equal(got["blocks.0.fc1.weight"].numpy(),
                              te.state_dict_from_flax(
                                  host, tcfg)["blocks.0.fc1.weight"])


def test_train_step_sharded_on_one_shard_is_train_step():
    """A 1 x 1 mesh runs train_step's arithmetic exactly."""
    cfg = te.EmbedderConfig(dtype="float32", **SMALL)
    a = te.TextEmbedder(cfg, seed=2, device="cpu").train_model()
    b = te.TextEmbedder(cfg, seed=2, device="cpu").train_model()
    m = tmesh.make_mesh(tmesh.MeshConfig(data=1), [CPU])
    sh = te.ShardedEncoder(m, b)
    batch = _tokens(cfg, seed=8)
    assert torch.equal(te.train_step(a, *batch, lr=1e-2),
                       te.train_step_sharded(m, sh, *batch, lr=1e-2))
    got = sh.state_dict()
    assert all(torch.equal(got[n], p) for n, p in a.state_dict().items())
    m2 = _meshes(2, 1)[1]
    with pytest.raises(ValueError, match="split"):
        te.train_step_sharded(m2, te.ShardedEncoder(m2, a),
                              *_tokens(cfg, seed=8, n=3), lr=1e-2)
    with pytest.raises(ValueError, match="another mesh"):
        te.train_step_sharded(m2, sh, *batch, lr=1e-2)

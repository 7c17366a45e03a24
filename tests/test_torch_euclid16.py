"""16-bit codes under Euclidean distance at 960 dims, the shape of the
benchmark's GIST-960 cell, on the CPU: search_many at `high` against the
benchmark's float64 reference (portbench/reference, plain PyTorch) by the
benchmark's own comparison and limits, the stored rows as the reference's
codec decodes them, the scan's launch counters on the int8 route (16-bit
codes split into high and low bytes), and the rerank counter.

Two kinds of rows: the benchmark generator's unit vectors ("unit"), over
which L2 ranks as cosine does (||q - x||^2 = ||q||^2 + 1 - 2 q.x), and
non-negative rows of varying norm, as GIST's descriptors are ("nonneg"),
over which a fault in the rows' norm term changes the answers.

4,096 x 960 rows are 3.9M stored elements, above HOST_SCAN_MAX_ELEMS, so
search_many takes the device path, whose kernels run their plain versions
on CPU tensors.  The same rows stored at 8 bits must fail the limits: the
comparison is tight enough to tell the configuration's precision from the
next one down.  The `cuda` cases run the fp32 tile loop (which K4 and the
other widths keep) at the cell's width and batch against its plain version
on the card, and search_many on a 16-bit collection there, through K1's
int8 route, against the f64 oracle."""

import json
import os
import types

import numpy as np
import pytest
import torch

import syzgydb_tpu_torch as tdb
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import scan
from portbench import compare, corpus
from portbench.reference.exact import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIMS, Q, K = 4096, 960, 64, 10
GEN = {"centers": 64, "spread": 0.35, "seed": 4500960}


def _limits() -> dict:
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "high-b1024.json")) as f:
        return json.load(f)["limits"]


def nonneg_rows(n: int, dims: int, seed: int):
    """(rows (n, dims) f32, queries (Q, dims) f64): clustered non-negative
    rows with norms spread over [0.3, 1], and queries near stored rows."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(64, dims, generator=g)
    rows = centers[torch.randint(0, 64, (n,), generator=g)]
    rows = (rows + 0.5 * torch.rand(n, dims, generator=g))
    rows *= (0.3 + 0.7 * torch.rand(n, 1, generator=g)) / rows.norm(
        dim=1, keepdim=True)
    src = rows[torch.randint(0, n, (Q,), generator=g)]
    noise = torch.randn(Q, dims, generator=g) / dims ** 0.5
    return rows, (src + 0.05 * noise).double().numpy()


@pytest.fixture(scope="module", params=["unit", "nonneg"])
def data(request):
    """(rows (N, D) f32, queries (Q, D) f64, the 16-bit reference)."""
    if request.param == "unit":
        rows, gen = corpus.make_rows(GEN, N, DIMS, torch.device("cpu"))
        queries = corpus.make_queries(rows, gen, Q, 0.2).double().numpy()
    else:
        rows, queries = nonneg_rows(N, DIMS, 960)
    return rows, queries, Reference(rows, bits=16, metric="euclidean")


def test_the_norm_term_orders_the_nonneg_rows_alone(data):
    """Over unit rows L2 ranks as cosine does, but where the 16-bit codes'
    norms break a near tie; over the non-negative rows of varying norm it
    does not, so their searches test the norm term."""
    rows, queries, ref = data
    cos = Reference(rows, bits=16, metric="cosine")
    dev = torch.device("cpu")
    same = (ref.topk(queries, K, dev)[1] == cos.topk(queries, K, dev)[1])
    share = same.all(dim=1).double().mean().item()
    if rows.norm(dim=1).std() < 1e-3:
        assert share >= 0.9
    else:
        assert share < 0.5


def _store(path, rows, bits: int):
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(path), distance_method=tdb.EUCLIDEAN, dimension_count=DIMS,
        quantization=bits, create_and_overwrite=True), device="cpu")
    c.add_documents(list(range(N)), rows.numpy(),
                    [compare.meta_of(i) for i in range(N)])
    return c


@pytest.fixture(scope="module", params=[16, 8])
def stored(request, data, tmp_path_factory):
    """(bits, the rows stored at `bits` under Euclidean distance)."""
    c = _store(tmp_path_factory.mktemp(f"e{request.param}") / "e.dat",
               data[0], request.param)
    assert not c._small()
    yield request.param, c
    c.close()


def _search(coll, queries):
    return coll.search_many([tdb.SearchArgs(vector=q, k=K, precision="high")
                             for q in queries])


def test_high_against_the_reference_at_the_cells_limits(data, stored):
    """16 bits: within every limit of high-b1024.  8 bits: the same rows
    fail rank_gap and dist_err, and nothing else."""
    _, queries, ref = data
    bits, coll = stored
    nums = compare.knn_numbers(ref, queries,
                               compare.from_results(_search(coll, queries)),
                               K, torch.device("cpu"))
    limits = _limits()
    over = {k for k, v in nums.items() if not v <= limits[k]}
    assert over == (set() if bits == 16 else {"rank_gap", "dist_err"}), nums


def test_get_document_reads_back_the_reference_codec(data, stored):
    """Every sampled row reads back as the 16-bit reference codec decodes
    it, metadata included; at 8 bits none does."""
    _, _, ref = data
    bits, coll = stored
    sample = np.random.default_rng(5).choice(N, size=256, replace=False)
    bad = compare.stored_bad(ref, coll.get_document, sample)
    assert bad == (0 if bits == 16 else len(sample))


def _fake_kernels(monkeypatch):
    """The CUDA route's dispatch on CPU tensors: _route's rule as on the
    card, each launch filled by the plain version (the int8 route's dq_rel
    0).  Returns the list of the stand-in fp32 kernels' launches (their
    csrc names), which grows as they run."""
    real = scan._route
    fp32_calls = []

    def route(codes, bits, kernel, q):
        on_cuda = types.SimpleNamespace(device=torch.device("cuda"),
                                        shape=codes.shape)
        return real(on_cuda, bits, kernel, q)

    monkeypatch.setattr(scan, "_route", route)
    monkeypatch.setattr(scan, "hilo_max_dims", lambda device: 992)

    def fp32(name, out, last, queries, codes, norms, valid, *, bits,
             metric, tile=None, defines=()):
        fp32_calls.append(name)
        if name == "segmin":
            out.copy_(scan.segment_min_scan_plain(
                queries, codes, norms, valid, bits=bits, metric=metric,
                seg=last))
        else:
            out.copy_(scan.score_surface_plain(
                queries, codes, norms, valid, bits=bits, metric=metric,
                exact=not last))

    def i8(symbol, out, last, queries, codes, norms, valid, metric, bits):
        assert symbol == "segmin_i8_launch"
        out.copy_(scan.segment_min_scan_plain(
            queries, codes, norms, valid, bits=bits, metric=metric,
            seg=last))
        return torch.zeros(queries.shape[0])

    monkeypatch.setattr(scan, "_launch_fp32", fp32)
    monkeypatch.setattr(scan, "_launch_i8", i8)
    return fp32_calls


def test_fp32_launches_count_the_fp32_route_alone(data, stored,
                                                  monkeypatch):
    """K1's fp32 launches (scan.launches less i8_launches) are exactly the
    stand-in fp32 kernel's K1 launches, and at the cell's width (D = 960,
    within hilo_max_dims) there are none at either width: every K1 launch
    of search_many is an int8 launch, and at 16 bits i8_hilo_launches
    counts every one; the answers are the plain route's."""
    _, queries, _ = data
    bits, coll = stored
    want = [[(r.id, r.distance) for r in res.results]
            for res in _search(coll, queries)]
    fp32_calls = _fake_kernels(monkeypatch)
    before = (scan.launches, scan.i8_launches, scan.i8_hilo_launches)
    got = [[(r.id, r.distance) for r in res.results]
           for res in _search(coll, queries)]
    n = scan.launches - before[0]
    assert n >= 1
    assert n - (scan.i8_launches - before[1]) == \
        fp32_calls.count("segmin") == 0
    assert scan.i8_hilo_launches - before[2] == (n if bits == 16 else 0)
    assert got == want


def _decoded_rows(monkeypatch) -> list:
    """Patch candidate_dots to note the (Q, C) rows of each decode."""
    seen = []
    orig = tdist.candidate_dots

    def noting(queries, ccodes, bits):
        seen.append(ccodes.shape[0] * ccodes.shape[1])
        return orig(queries, ccodes, bits)

    monkeypatch.setattr(tdist, "candidate_dots", noting)
    return seen


@pytest.mark.parametrize("how", ["fused", "fused_chunks", "surface"])
def test_rerank_rows_equal_the_rows_decoded(data, monkeypatch, how):
    """rerank_rows adds every row _candidate_distances decodes: (k + margin
    + 1) segments of 32 rows a query in the fused scan, in one chunk or
    several, and k + margin rows a query over K4's surface."""
    rows, queries, _ = data
    _, codes, norms = tdist.ingest_reprs(rows.double().numpy(), 16)
    tc, tn = torch.from_numpy(codes), torch.from_numpy(norms)
    tv = torch.ones(N, dtype=torch.bool)
    tq = torch.from_numpy(queries).float()
    seen = _decoded_rows(monkeypatch)
    before = scan.rerank_rows
    margin = 6
    if how == "surface":
        scan.surface_topk(tq, tc, tn, tv, bits=16, metric="euclidean", k=K,
                          margin=margin, budget_bytes=4 << 20)
        want = Q * (K + margin)
    else:
        chunk = {"fused": scan.GATHER_BUDGET_BYTES,
                 "fused_chunks": 4 * 17 * 32 * DIMS * 5}[how]
        scan.fused_scan_topk(tq, tc, tn, tv, bits=16, metric="euclidean",
                             k=K, tie_margin=margin, with_ties=True,
                             gather_bytes=chunk)
        want = Q * (K + margin + 1) * scan.DEFAULT_SEG
    assert len(seen) > (1 if how != "fused" else 0)
    assert scan.rerank_rows - before == sum(seen) == want


@pytest.mark.cuda
def test_fp32_tile_loop_at_the_cells_width():
    """K1's fp32 kernel at Q = 1,024, D = 960 and 16-bit codes (the GIST
    cell's launch) over non-negative rows of varying norm against its
    plain version in f64: identical +inf positions, finite minima within
    surface_delta; one launch, none of it int8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(960)
    rows, _ = nonneg_rows(8192, DIMS, 960)
    db = rows.double().numpy()
    _, codes, norms = tdist.ingest_reprs(db, 16)
    valid = rng.random(8192) > 0.05
    valid[64:96] = False
    queries = db[rng.integers(0, 8192, 1024)] + \
        0.05 * rng.standard_normal((1024, DIMS)) / np.sqrt(DIMS)
    tq, tc, tn, tv = (torch.from_numpy(a).to(dev) for a in (
        np.float32(queries), codes, norms, valid))
    before = (scan.launches, scan.i8_launches)
    got = scan.segmin_fp32(tq, tc, tn, tv, bits=16, metric="euclidean",
                           seg=scan.DEFAULT_SEG)
    assert (scan.launches, scan.i8_launches) == (before[0] + 1, before[1])
    want = scan.segment_min_scan_plain(tq, tc, tn, tv, bits=16,
                                       metric="euclidean",
                                       dtype=torch.float64)
    delta = scan.surface_delta(tq.square().sum(-1), tn, tv,
                               metric="euclidean", dims=DIMS)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    err = (got.double() - want).abs()
    assert (err[fin] <= delta.double()[:, None].expand_as(err)[fin]).all()


@pytest.mark.cuda
def test_search_many_on_the_int8_route_at_the_cells_width(tmp_path):
    """search_many at `high` on a 16-bit Euclidean collection on the card,
    over non-negative rows of varying norm at D = 960: K1 runs the int8
    route's 16-bit form alone (i8_hilo_launches rises with every K1
    launch), and the ids are the f64 oracle's.  The same scan, held to its
    flag up the margin ladder, proves every query and returns those ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n = 8192
    rows, queries = nonneg_rows(n, DIMS, 961)
    ref = Reference(rows, bits=16, metric="euclidean")
    want = ref.topk(queries, K, dev)[1].cpu().tolist()
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(tmp_path / "h.dat"), distance_method=tdb.EUCLIDEAN,
        dimension_count=DIMS, quantization=16), device="cuda")
    c.add_documents(list(range(n)), rows.numpy(), [b"{}"] * n)
    assert not c._small()
    before = (scan.launches, scan.i8_launches, scan.i8_hilo_launches)
    got = [[r.id for r in res.results] for res in _search(c, queries)]
    c.close()
    k1 = scan.launches - before[0]
    assert k1 >= 1
    assert scan.i8_launches - before[1] == k1
    assert scan.i8_hilo_launches - before[2] == k1
    assert got == want
    _, codes, norms = tdist.ingest_reprs(rows.double().numpy(), 16)
    tq, tc, tn = (torch.from_numpy(a).to(dev) for a in (
        np.float32(queries), codes, norms))
    tv = torch.ones(n, dtype=torch.bool, device=dev)
    for margin in (6, 64, 512, n // scan.DEFAULT_SEG):
        _, ids, ok = scan.fused_scan_topk(tq, tc, tn, tv, bits=16,
                                          metric="euclidean", k=K,
                                          tie_margin=margin, with_ties=True)
        if bool(ok.all()):
            break
    assert bool(ok.all())
    assert ids.cpu().tolist() == want

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the `cuda` marker and skips where
torch.cuda.is_available() is False.  The file imports nothing of JAX, so
on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the segment minima of K1/K5/K6 and K4's f32 surface must lie
within the completeness flag's own error bound (surface_delta: the f32
accumulation cushion, as the fp32 kernels round neither queries nor codes,
plus the query-slicing error dq_rel on K1's int8 route) of an f64
evaluation of the same formula, with identical +inf positions; K1's int8
route also within 4 f32 ulps of the surrogate's terms (i8_term_scale) of
an f64 evaluation on its sliced queries q_hat, which a fault in the
fragment layout would break; K4's bf16 surface within its bound plus half
a bf16 ulp of the value; K2's (f32 and bf16) and K3's integer counts must
match exactly."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import syzgydb_tpu_torch as tdb
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import hamming_scan
from syzgydb_tpu_torch.ops import scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corpus(bits, n, d, q, seed, zero_query=True, dead=(64, 96)):
    """Uniform vectors with zero rows (every 97th), 5% invalid rows and the
    wholly invalid rows dead[0]:dead[1]; query 0 is zero when
    zero_query."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, size=(n, d))
    db[::97] = 0.0
    _, codes, norms = tdist.ingest_reprs(db, bits)
    if bits == 64:
        codes = np.float32(codes)
    valid = rng.random(n) > 0.05
    valid[dead[0]:dead[1]] = False
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    if zero_query:
        queries[0] = 0.0
    return queries, codes, norms, valid


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("bits", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n,d,q", [(4096, 384, 130), (1056, 33, 3)])
def test_segmin_kernel_matches_plain(cuda, bits, metric, n, d, q):
    queries, codes, norms, valid = _corpus(bits, n, d, q, seed=bits)
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = (scan.launches, scan.i8_launches)
    got = scan.segment_min_scan(tq, tc, tn, tv, bits=bits, metric=metric)
    # 8-bit codes at seg 32 take the int8 route, the rest the fp32 kernel
    assert (scan.launches, scan.i8_launches) == \
        (before[0] + 1, before[1] + (bits == 8))
    want = scan.segment_min_scan_plain(tq, tc, tn, tv, bits=bits,
                                       metric=metric, dtype=torch.float64)
    dq_rel = scan.slice_queries(tq)[2] if bits == 8 else None
    delta = scan.surface_delta(tq.square().sum(-1), tn, tv, metric=metric,
                               dims=d, dq_rel=dq_rel, bits=bits)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    err = (got.double() - want).abs()
    bound = delta.double()[:, None].expand_as(err)
    assert (err[fin] <= bound[fin]).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,d,q,zero_query", [
    (4096, 384, 130, True), (1056, 33, 3, True), (2048, 768, 17, True),
    (4096, 100, 1, False), (4096, 100, 1, True), (4096, 48, 40, True),
    # past the resident kernel's shared memory: the streamed-slice kernel
    (2080, 800, 5, True), (1024, 1504, 70, True)])
def test_i8_segmin_kernel_tight_on_q_hat(cuda, metric, n, d, q, zero_query):
    """The int8 route against an f64 evaluation of the same formula on its
    sliced queries q_hat with the unrounded |q|^2 and sum: within 4 f32
    ulps of the surrogate's terms, identical +inf positions (invalid rows,
    a wholly invalid segment; zero rows and a zero query ride along)."""
    queries, codes, norms, valid = _corpus(8, n, d, q, seed=n + d + q,
                                           zero_query=zero_query)
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = scan.i8_launches
    got = scan.segment_min_scan(tq, tc, tn, tv, bits=8, metric=metric)
    assert scan.i8_launches == before + 1
    slices, scale, _ = scan.slice_queries(tq)
    qhat = scan.unslice_queries(slices, scale)[:, :d]
    qn2 = tq.square().sum(-1)
    want = scan.segment_min_scan_plain(qhat, tc, tn, tv, bits=8,
                                       metric=metric, dtype=torch.float64,
                                       query_terms=(qn2, tq.sum(-1)))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isinf(got[:, 2]).all()  # rows 64..95: a wholly invalid segment
    tol = 4 * 2.0 ** -24 * scan.i8_term_scale(qn2, tn, tv, metric=metric,
                                              dims=d).double()[:, None]
    fin = torch.isfinite(want)
    err = (got.double() - want).abs()
    assert (err[fin] <= tol.expand_as(err)[fin]).all()


def test_i8_route_rejects_what_it_cannot_take(cuda):
    n, d = 32, scan.I8_MAX_DIMS + 32  # int32 slice sums could overflow
    args = (torch.zeros((1, d), device=cuda),
            torch.zeros((n, d), dtype=torch.int8, device=cuda),
            torch.zeros(n, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="int8 route"):
        scan.segment_min_scan(*args, bits=8, metric="cosine")


def _within_delta(got, want, tq, tn, tv, metric, d, extra=None, bits=None):
    """got (kernel) against want (plain, f64): identical +inf positions,
    finite errors within surface_delta (+ `extra`, elementwise); at 8 bits
    (the int8 route) with slice_queries' dq_rel."""
    dq_rel = scan.slice_queries(tq)[2] if bits == 8 else None
    delta = scan.surface_delta(tq.square().sum(-1), tn, tv, metric=metric,
                               dims=d, dq_rel=dq_rel, bits=bits)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    err = (got.double() - want).abs()
    bound = delta.double()[:, None].expand_as(err)
    if extra is not None:
        bound = bound + extra
    assert (err[fin] <= bound[fin]).all()


@pytest.mark.parametrize("seg", [16, 64, 128])
@pytest.mark.parametrize("bits", [4, 8, 16, 64])
@pytest.mark.parametrize("n,d,q", [(4096, 384, 130), (1152, 33, 3)])
def test_free_seg_segmin_kernel_matches_plain(cuda, bits, seg, n, d, q):
    metric = "cosine" if bits in (8, 64) else "euclidean"
    queries, codes, norms, valid = _corpus(bits, n, d, q, seed=seg)
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = (scan.launches, scan.free_seg_launches,
              scan.i8_free_seg_launches)
    got = scan.segment_min_scan(tq, tc, tn, tv, bits=bits, metric=metric,
                                seg=seg)
    # 8-bit codes take the int8 route at every segment length
    assert (scan.launches, scan.free_seg_launches,
            scan.i8_free_seg_launches) == \
        (before[0], before[1] + 1, before[2] + (bits == 8))
    want = scan.segment_min_scan_plain(tq, tc, tn, tv, bits=bits,
                                       metric=metric, seg=seg,
                                       dtype=torch.float64)
    _within_delta(got, want, tq, tn, tv, metric, d, bits=bits)
    with pytest.raises(ValueError, match="16, 32, 64, 128"):
        scan.segment_min_scan(tq, tc, tn, tv, bits=bits, metric=metric,
                              seg=48 if n % 48 == 0 else 8)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("bits", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n,d,q", [(4096, 384, 130), (1000, 33, 3)])
def test_surface_kernel_matches_plain(cuda, bits, metric, exact, n, d, q):
    queries, codes, norms, valid = _corpus(bits, n, d, q, seed=bits + 1)
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = (scan.surface_launches, scan.i8_surface_launches)
    got = scan.score_surface(tq, tc, tn, tv, bits=bits, metric=metric,
                             exact=exact)
    # 8-bit codes take the int8 route
    assert (scan.surface_launches, scan.i8_surface_launches) == \
        (before[0] + 1, before[1] + (bits == 8))
    assert got.dtype == (torch.float32 if exact else torch.bfloat16)
    want = scan.score_surface_plain(tq, tc, tn, tv, bits=bits, metric=metric,
                                    dtype=torch.float64)
    half_ulp = None
    if not exact:
        # half an ulp at the larger magnitude (the two may straddle a
        # power of 2)
        fin = torch.isfinite(want)
        a = torch.where(fin, torch.maximum(want.abs(), got.double().abs()),
                        torch.ones_like(want))
        half_ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(
            a.clamp_min(1e-30))) - 8), torch.zeros_like(a))
    _within_delta(got.float(), want, tq, tn, tv, metric, d, half_ulp,
                  bits=bits)


def _half_ulp_bf16(a):
    """Half a bf16 ulp at |a| (8 significant bits), 0 at 0."""
    a = a.abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(
        a.clamp_min(1e-30))) - 8), torch.zeros_like(a))


def _tight_on_q_hat(got, tq, tc, tn, tv, metric, d, seg=None, bf16=False):
    """The int8 route against an f64 evaluation of the same formula on its
    sliced queries q_hat with the unrounded |q|^2 and sum: within 4 f32
    ulps of the surrogate's terms (bf16: plus half a bf16 ulp), identical
    +inf positions.  seg=None: the full surface."""
    slices, scale, _ = scan.slice_queries(tq)
    qhat = scan.unslice_queries(slices, scale)[:, :d]
    qn2 = tq.square().sum(-1)
    terms = (qn2, tq.sum(-1))
    if seg is None:
        want = scan.score_surface_plain(qhat, tc, tn, tv, bits=8,
                                        metric=metric, dtype=torch.float64,
                                        query_terms=terms)
    else:
        want = scan.segment_min_scan_plain(qhat, tc, tn, tv, bits=8,
                                           metric=metric, seg=seg,
                                           dtype=torch.float64,
                                           query_terms=terms)
    got = got.double()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    tol = 4 * 2.0 ** -24 * scan.i8_term_scale(qn2, tn, tv, metric=metric,
                                              dims=d).double()[:, None]
    fin = torch.isfinite(want)
    err = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    bound = tol.expand_as(err)
    if bf16:
        bound = bound + _half_ulp_bf16(torch.where(
            fin, torch.maximum(want.abs(), got.abs()), torch.zeros_like(want)))
    assert (err <= bound).all(), float((err / bound).max())
    return want


# (N, D, Q): D = 1504 runs the streamed-slice kernel
_I8_TIGHT = [(4096, 384, 130), (1152, 33, 3), (2048, 768, 17),
             (1024, 1504, 70)]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("seg", [16, 64, 128])
@pytest.mark.parametrize("n,d,q", _I8_TIGHT)
def test_i8_free_seg_kernel_tight_on_q_hat(cuda, seg, metric, n, d, q):
    """K5/K6 on the int8 route, held as K1's is: a wholly invalid 128-row
    block (a whole segment at every length), zero rows and a zero query."""
    queries, codes, norms, valid = _corpus(8, n, d, q, seed=n + d + seg,
                                           dead=(256, 384))
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = scan.i8_free_seg_launches
    got = scan.segment_min_scan(tq, tc, tn, tv, bits=8, metric=metric,
                                seg=seg)
    assert scan.i8_free_seg_launches == before + 1
    assert got.shape == (q, n // seg)
    assert torch.isinf(got[:, 256 // seg:384 // seg]).all()
    _tight_on_q_hat(got, tq, tc, tn, tv, metric, d, seg=seg)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,d,q", _I8_TIGHT[:2] + [(1000, 33, 3)] +
                         _I8_TIGHT[2:])
def test_i8_surface_kernel_tight_on_q_hat(cuda, exact, metric, n, d, q):
    """K4 on the int8 route, f32 and bf16 (N = 1000: a tail of 8 rows in
    the last 32-row tile, never stored past N)."""
    queries, codes, norms, valid = _corpus(8, n, d, q, seed=n + d + q,
                                           dead=(256, 384))
    tq, tc, tn, tv = (torch.from_numpy(a).to(cuda)
                      for a in (queries, codes, norms, valid))
    before = scan.i8_surface_launches
    got = scan.score_surface(tq, tc, tn, tv, bits=8, metric=metric,
                             exact=exact)
    assert scan.i8_surface_launches == before + 1
    assert got.shape == (q, n)
    assert got.dtype == (torch.float32 if exact else torch.bfloat16)
    assert torch.isinf(got[:, 256:384]).all()
    want = _tight_on_q_hat(got, tq, tc, tn, tv, metric, d, bf16=not exact)
    if not exact:
        # the same f32 value rounded to nearest: within half a bf16 ulp of
        # the f32 surface the f32 launch writes
        f32 = scan.score_surface(tq, tc, tn, tv, bits=8, metric=metric,
                                 exact=True)
        fin = torch.isfinite(want)
        assert torch.equal(got[fin], f32[fin].to(torch.bfloat16))


@pytest.mark.parametrize("words", [5, 8])
def test_hamming_u8_kernel_bit_exact(cuda, words):
    rng = np.random.default_rng(words + 10)
    n, q = 5000, 40
    qc = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    h = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    h[0] = ~qc[0]  # 32 * words: wraps to 0 at W = 8
    args = [torch.from_numpy(a).to(cuda) for a in
            (qc.view(np.int32), h.view(np.int32))]
    before = hamming_scan.u8_launches
    got = hamming_scan.hamming_scores_u8(*args)
    assert hamming_scan.u8_launches == before + 1
    assert got.dtype == torch.uint8
    assert torch.equal(got, hamming_scan.hamming_scores_u8_plain(*args))
    assert int(got[0, 0]) == (32 * words) % 256


@pytest.mark.parametrize("words", [1, 5, 7])
def test_hamming_kernel_bit_exact(cuda, words):
    rng = np.random.default_rng(words)
    n, q = 5000, 40
    qc = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    h = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    valid = rng.random(n) > 0.1
    args = [torch.from_numpy(a).to(cuda) for a in
            (qc.view(np.int32), h.view(np.int32), valid)]
    before = hamming_scan.launches
    got = hamming_scan.hamming_scores(*args)
    assert hamming_scan.launches == before + 1
    assert torch.equal(got, hamming_scan.hamming_scores_plain(*args))


def _one_bit_rows(qcode):
    """32 W rows that each differ from `qcode` (W,) in exactly one bit."""
    w = len(qcode)
    rows = np.repeat(qcode[None, :], 32 * w, axis=0)
    for b in range(32 * w):
        rows[b, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return rows


def _hamming_all_forms(qc, h, valid):
    """K2 (f32, bf16) and K3 on CUDA tensors, each held bit for bit against
    its plain version and counted once; -> the three surfaces."""
    out = []
    for form in (torch.float32, torch.bfloat16, None):
        before = (hamming_scan.launches, hamming_scan.u8_launches)
        if form is None:
            got = hamming_scan.hamming_scores_u8(qc, h)
            want = hamming_scan.hamming_scores_u8_plain(qc, h)
            assert hamming_scan.u8_launches == before[1] + 1
        else:
            got = hamming_scan.hamming_scores(qc, h, valid, out_dtype=form)
            want = hamming_scan.hamming_scores_plain(qc, h, valid,
                                                     out_dtype=form)
            assert hamming_scan.launches == before[0] + 1
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (form, tuple(qc.shape), h.shape[0])
        out.append(got)
    return out


@pytest.mark.parametrize("n", [1000, 5000, 65536])
@pytest.mark.parametrize("words", range(1, 9))
def test_hamming_tc_kernels_bit_exact(cuda, words, n):
    """The tensor-core K2 (f32 and bf16) and K3 at Q = 1, 7, 8, 40, 64, 129
    (Q and N tails), with rows one bit away from query 0 at every bit, the
    complement of query 1 (256 wraps to 0 at W = 8) and invalid rows."""
    rng = np.random.default_rng(1000 * words + n)
    h = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    valid = rng.random(n) > 0.05
    th_valid = torch.from_numpy(valid).to(cuda)
    for q in (1, 7, 8, 40, 64, 129):
        qc = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
        h[:32 * words] = _one_bit_rows(qc[0])
        if q > 1:
            h[32 * words] = ~qc[1]
        tqc = torch.from_numpy(qc.view(np.int32)).to(cuda)
        th = torch.from_numpy(h.view(np.int32)).to(cuda)
        f32, _, u8 = _hamming_all_forms(tqc, th, th_valid)
        assert (u8[0, :32 * words] == 1).all()
        if q > 1:
            assert int(u8[1, 32 * words]) == (32 * words) % 256


def test_hamming_tc_kernels_misaligned_views(cuda):
    """A hashes view 20 bytes into its storage (W = 5: not 16-byte aligned)
    is refused before any launch (the kernel bulk-copies whole blocks from
    a 16-byte aligned start), and a validity view at an odd address is
    re-aligned by the wrapper and runs, counted once a launch."""
    rng = np.random.default_rng(77)
    n, words, q = 5000, 5, 40
    qc = torch.from_numpy(rng.integers(0, 2**32, size=(q, words),
                                       dtype=np.uint32).view(np.int32)).to(cuda)
    h = rng.integers(0, 2**32, size=(n + 1, words), dtype=np.uint32)
    valid = rng.random(n + 1) > 0.05
    full = torch.from_numpy(h.view(np.int32)).to(cuda)
    tv = torch.from_numpy(valid).to(cuda)[1:]
    assert full[1:].is_contiguous() and full[1:].data_ptr() % 16 != 0
    assert tv.data_ptr() % 16 != 0
    before = (hamming_scan.launches, hamming_scan.u8_launches)
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores(qc, full[1:], tv)
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores_u8(qc, full[1:])
    assert (hamming_scan.launches, hamming_scan.u8_launches) == before
    _hamming_all_forms(qc, full[:n], tv)


def test_wrappers_reject_cuda_input_they_cannot_take(cuda):
    qc = torch.zeros((2, 9), dtype=torch.int32, device=cuda)
    h = torch.zeros((64, 9), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):  # W=9 exceeds the kernel's words
        hamming_scan.hamming_scores(qc, h, torch.ones(64, dtype=torch.bool,
                                                      device=cuda))
    codes = torch.zeros((64, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # non-contiguous codes
        scan.segment_min_scan(
            torch.zeros((1, 4), device=cuda), codes[:, ::2],
            torch.zeros(64, device=cuda),
            torch.ones(64, dtype=torch.bool, device=cuda), bits=8,
            metric="cosine")


@pytest.mark.parametrize("bits", [4, 8, 64])
def test_cuda_collection_matches_cpu(cuda, tmp_path, monkeypatch, bits):
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    rng = np.random.default_rng(bits)
    vecs = rng.uniform(-1, 1, size=(3000, 64))
    out = {}
    for dev in ("cpu", "cuda"):
        c = tdb.Collection(tdb.CollectionOptions(
            name=str(tmp_path / f"{dev}.dat"), distance_method=tdb.COSINE,
            dimension_count=64, quantization=bits, index_seed=5,
            search_budget=96), device=dev)
        c.add_documents(list(range(3000)), vecs, [b"{}"] * 3000)
        out[dev] = [[r.id for r in res.results] for p in
                    ("high", "exact", "medium") for res in c.search_many(
                        [tdb.SearchArgs(vector=v, k=10, precision=p)
                         for v in vecs[:20]])]
        out[dev] += [[r.id for r in c.search(tdb.SearchArgs(
            vector=vecs[3], k=10)).results]]
        c.close()
    assert out["cpu"] == out["cuda"]


def test_cuda_scatter_filter_and_large_k_match_cpu(cuda, tmp_path,
                                                   monkeypatch):
    """The GPU placement's in-place scatter sync, callable filters and the
    non-fused large-k fallback give the CPU placement's results."""
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    rng = np.random.default_rng(11)
    vecs = rng.uniform(-1, 1, size=(3000, 32))
    queries = rng.uniform(-1, 1, size=(300, 32))
    out = {}
    for dev in ("cpu", "cuda"):
        c = tdb.Collection(tdb.CollectionOptions(
            name=str(tmp_path / f"{dev}.dat"),
            distance_method=tdb.EUCLIDEAN, dimension_count=32,
            quantization=16, index_seed=5), device=dev)
        c.add_documents(list(range(3000)), vecs, [b"{}"] * 3000)
        c.search(tdb.SearchArgs(vector=queries[0], k=5, precision="high"))
        c.add_document(7000, queries[1], b"{}")
        c.remove_document(42)
        got = [[r.id for r in c.search(tdb.SearchArgs(
            vector=queries[1], k=5, precision="high")).results]]
        assert c.sync_stats == {"full": 1, "scatter": 1}
        got += [[r.id for r in c.search(tdb.SearchArgs(
            vector=queries[2], k=9, precision=p,
            filter=lambda i, md: i % 3 == 0)).results]
            for p in ("high", "exact")]
        # k=300 at 300 queries exceeds the fused scan: full-surface top-k
        big = c.search_many([tdb.SearchArgs(vector=q, k=300, precision="high")
                             for q in queries])
        got += [[r.id for r in res.results] for res in big[:5]]
        out[dev] = got
        c.close()
    assert out["cpu"][0][0] == 7000
    assert out["cpu"] == out["cuda"]


def test_cuda_radius_and_filters_match_cpu(cuda, tmp_path, monkeypatch):
    """Radius (fused at kk = 1024, then the K4 branch for a 72-query group
    and a 1024+ row radius) and query-string filters on the GPU placement
    give the CPU placement's results."""
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    rng = np.random.default_rng(12)
    vecs = rng.uniform(-1, 1, size=(3000, 16))
    queries = rng.uniform(-1, 1, size=(72, 16))
    radii = [0.3] * 72
    radii[5] = 0.48
    out, medium = {}, {}
    for dev in ("cpu", "cuda"):
        c = tdb.Collection(tdb.CollectionOptions(
            name=str(tmp_path / f"{dev}.dat"), distance_method=tdb.COSINE,
            dimension_count=16, quantization=8, index_seed=5), device=dev)
        c.add_documents(list(range(3000)), vecs,
                        [b'{"i": %d}' % i for i in range(3000)])
        surf0 = scan.surface_launches
        got = []
        for p in ("high", "exact", "medium"):
            sets = [sorted(r.id for r in res.results) for res in
                    c.radius_many([tdb.SearchArgs(vector=q, radius=r,
                                                  precision=p)
                                   for q, r in zip(queries, radii)])]
            if p == "medium":
                medium[dev] = sets
            else:
                got += sets
        got += [[r.id for r in c.search(tdb.SearchArgs(
            vector=queries[1], k=10, filter_query="i < 1500",
            precision=p)).results] for p in ("high", "exact")]
        got += [sorted(r.id for r in c.search(tdb.SearchArgs(
            vector=queries[5], radius=0.48, filter_query="i >= 2000",
            precision="high")).results)]
        got += [[r.id for r in c.search(tdb.SearchArgs(
            filter_query="i >= 2990", limit=5)).results]]
        if dev == "cuda":
            assert scan.surface_launches > surf0
        out[dev] = got
        c.close()
    assert len(out["cpu"][5]) > 1024
    assert out["cpu"] == out["cuda"]
    # medium's sketch candidates are a torch.topk over integer Hamming
    # counts, whose ties at the budget boundary the CPU and CUDA topk break
    # differently: the id sets must overlap, not match
    pairs = [(set(a), set(b)) for a, b in zip(medium["cpu"], medium["cuda"])]
    assert sum(len(a & b) for a, b in pairs) >= \
        0.98 * sum(len(a | b) for a, b in pairs)


def _chip_smoke():
    """chip_smoke.py, loaded by path: the serving phase's REST flow steps
    (rest_flow_steps) are this test's too."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _medium_bounds(coll, qvecs, vecs64):
    """What any medium answer of `coll` may hold, per query: medium reranks
    the `budget` rows of least Hamming count, so every candidate set holds
    the rows below the budget's count (`sure`) and some of those at it
    (`tied`); the CPU and CUDA torch.topk pick different tied rows.  Counts
    by the plain K2 on the host; `vecs64[i]` is record i's vector.  -> per
    query (sure, sure + tied, fp64 top-10 of sure, fp64 top-10 of sure +
    tied), as sets of ids."""
    state = coll._device_state()
    budget = min(max(coll.options.search_budget, 40), coll.columns.capacity)
    valid = state["valid"].cpu()
    qcode = torch.from_numpy(coll.index.encode_np(qvecs).view(np.int32))
    ham = hamming_scan.hamming_scores_plain(qcode, state["hashes"].cpu(),
                                            valid)
    cut = torch.kthvalue(ham, budget, dim=1).values[:, None]
    ids = np.where(valid.numpy(), coll.columns.ids[:len(valid)], 0)
    v = vecs64[ids] / np.linalg.norm(vecs64[ids], axis=1, keepdims=True)
    q = qvecs.astype(np.float64)
    dist = -(q / np.linalg.norm(q, axis=1, keepdims=True)) @ v.T

    def top10(d, keep):
        return set(ids[np.argsort(np.where(keep, d, np.inf),
                                  kind="stable")[:10]].tolist())

    return [(set(ids[s].tolist()), set(ids[m].tolist()), top10(d, s),
             top10(d, m)) for d, s, m in
            zip(dist, (ham < cut).numpy(), (ham <= cut).numpy())]


@pytest.mark.parametrize("rows", ["clustered", "gaussian"])
def test_cuda_rest_flow_matches_cpu(cuda, tmp_path, monkeypatch, rows):
    """The default-quantization REST flow of chip_smoke.py (create,
    inserts, searches, metadata update, record delete, ids and stats,
    restart, searches, collection delete) at 65,536 x 64 (4.2 M elements,
    past HOST_SCAN_MAX_ELEMS: the device branches) on the CUDA server and
    on the CPU one, each search step 24 high and 8 default-precision
    (medium) searches one at a time: equal JSON shapes and equal high ids.
    Medium ids may differ only through the rows tied at the sketch budget's
    Hamming count, which the CPU and CUDA torch.topk break differently:
    each device's answer holds the fp64 top-10 of all candidates wherever
    that lies below the tie, lies in the top-10 of the rows below it
    otherwise, and never leaves the tied rows (_medium_bounds).  On 256
    clusters each query's top-10 lies in its own cluster, well inside the
    2048-row budget, and the two devices' medium id sets also overlap by
    98%; on Gaussian rows the ties reach the top-10 (PERF.md).  Both
    servers run with random_seed 7, so they draw the same sketch planes."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(21)
    if rows == "clustered":
        centers = rng.standard_normal((256, 64)).astype(np.float32)
        vecs = centers[rng.integers(0, 256, 65536)] + \
            0.25 * rng.standard_normal((65536, 64)).astype(np.float32)
        queries = vecs[rng.integers(0, 65536, 24)] + \
            0.1 * rng.standard_normal((24, 64)).astype(np.float32)
    else:
        vecs = rng.standard_normal((65536, 64)).astype(np.float32)
        queries = rng.standard_normal((24, 64)).astype(np.float32)
    path = "/api/v1/collections/flow/search"
    vecs64 = vecs.astype(np.float64)
    before = (scan.launches, scan.i8_launches)
    # one random_seed for both servers: the same index seed and the same
    # calibration sample, so both placements draw the same sketch planes
    from syzgydb_tpu_torch.utils.rng import my_random
    monkeypatch.setattr(my_random, "_rng", my_random._rng)
    monkeypatch.setattr(my_random, "_seed", my_random._seed)
    out = {}
    for dev in ("cpu", "cuda"):
        high, medium = [], []

        def search(tag, srv, port):
            res = []
            for q in queries:
                res.append(smoke.http_call(port, "POST", path, {
                    "vector": q.tolist(), "k": 10, "precision": "high"}))
                high.append([r["id"] for r in res[-1]["results"]])
            for q, (sure, tied, top_sure, top_all) in zip(
                    queries[:8], _medium_bounds(srv.collections["flow"],
                                                queries[:8], vecs64)):
                res.append(smoke.http_call(port, "POST", path, {
                    "vector": q.tolist(), "k": 10}))
                got = {r["id"] for r in res[-1]["results"]}
                assert got <= tied and top_all & sure <= got and \
                    got & sure <= top_sure, (dev, tag, sorted(got))
                medium.append(got)
            return res

        (tmp_path / dev).mkdir()
        my_random.seed(7)
        out[dev] = (smoke.rest_flow_steps(str(tmp_path / dev), vecs, dev,
                                          search, 8192), high, medium)
    # the CUDA server's high searches ran the fp32 K1 (segmin.cu) alone
    assert scan.launches > before[0] and scan.i8_launches == before[1]
    assert out["cpu"][0] == out["cuda"][0]
    assert out["cpu"][1] == out["cuda"][1]
    pairs = list(zip(out["cpu"][2], out["cuda"][2]))
    common = sum(len(a & b) for a, b in pairs)
    union = sum(len(a | b) for a, b in pairs)
    print(f"medium id sets, {rows} rows: {common} common of {union}")
    if rows == "clustered":
        assert common >= 0.98 * union, (common, union)

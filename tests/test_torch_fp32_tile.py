"""The fp32 kernels' query tile and launch operands (ops/scan.py), on the
CPU.

K1, K5/K6 and K4 on 4-, 16-, 32- and 64-bit codes run csrc/scan_tile.cuh's
tile loop at one of four query tiles (16, 32, 64, 128), chosen from Q by
fp32_query_tile; a launch computes Q rounded up to a multiple of its tile.
These tests pin that choice (every Q >= 1 gets a tile, no launch pads Q by
a whole tile, the tile never shrinks as Q grows) and the operands the
wrappers hand the C entry points, read back through a stand-in for the
entry point: the queries transposed and zero-padded to (Kp, Qp), the
codes' row bytes and copy width, and the pass-through arguments.  The
same stand-in reads back the int8 route's operands (csrc/segmin_i8.cu),
and scan._route's rule is pinned on stand-in CUDA codes: 8-bit codes and
16-bit K1/K5/K6 up to hilo_max_dims (but small batches on narrow rows)
take the int8 route, the rest the fp32 kernels.  The kernels themselves
run only on the card (tests/test_torch_cuda.py)."""

import ctypes
import types

import numpy as np
import pytest
import torch

from syzgydb_tpu_torch.ops import cuda_build
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import scan


def _padded(q, tile):
    return -(-q // tile) * tile


def test_fp32_query_tile_covers_every_q():
    prev = 0
    for q in range(1, 4097):
        t = scan.fp32_query_tile(q)
        assert t in scan.FP32_TILES
        # no launch pads Q by a whole tile of its own
        assert _padded(q, t) - q < t
        # the smallest tile that holds Q, or the largest one
        assert t >= min(q, scan.FP32_TILES[-1])
        smaller = [x for x in scan.FP32_TILES if x < t]
        assert not smaller or smaller[-1] < q
        assert t >= prev  # monotone in Q
        prev = t


@pytest.mark.parametrize("q,tile,padded", [
    (1, 16, 16), (15, 16, 16), (16, 16, 16), (17, 32, 32), (28, 32, 32),
    (32, 32, 32), (33, 64, 64), (64, 64, 64), (65, 128, 128),
    (128, 128, 128), (129, 128, 256), (1024, 128, 1024),
    (1025, 128, 1152)])
def test_fp32_query_tile_at_the_batchers_sizes(q, tile, padded):
    """The batcher's groups (kNN up to 64, radius up to 16) and the main
    path's batches: Q = 16 computes 16 queries, Q = 17 at most 32."""
    assert scan.fp32_query_tile(q) == tile
    assert _padded(q, tile) == padded


class _Entry:
    """Stand-in for a kernel's C entry point: records its arguments and
    copies the query operand out of memory while the wrapper holds it."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        (qt, codes, norms, valid, qn2, qsum, out, q, qp, n, kp, row_bytes,
         bits, cosine, scale, offset, last, tile, vec, stream) = args
        buf = (ctypes.c_float * (kp * qp)).from_address(qt)
        self.calls.append(dict(
            qt=np.ctypeslib.as_array(buf).reshape(kp, qp).copy(),
            codes=codes, q=q, qp=qp, n=n, kp=kp, row_bytes=row_bytes,
            bits=bits, cosine=cosine, scale=scale, offset=offset,
            last=last, tile=tile, vec=vec))
        return 0


@pytest.fixture
def entry(monkeypatch):
    fake = _Entry()
    monkeypatch.setattr(cuda_build, "entry", lambda *a, **k: fake)
    monkeypatch.setattr(cuda_build, "launch_stream", lambda device: 0)
    return fake


def _inputs(bits, n, d, q, seed):
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, size=(n, d))
    _, codes, norms = tdist.ingest_reprs(db, bits)
    if bits == 64:
        codes = np.float32(codes)
    valid = rng.random(n) > 0.1
    queries = np.float32(rng.uniform(-1, 1, size=(q, d)))
    return tuple(torch.from_numpy(a) for a in (queries, codes, norms, valid))


@pytest.mark.parametrize("kind", ["segmin", "surface"])
@pytest.mark.parametrize("bits", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n,d,q", [(1024, 33, 1), (1024, 33, 17),
                                   (512, 384, 65), (256, 100, 130)])
def test_fp32_launch_operands(entry, kind, bits, n, d, q):
    tq, tc, tn, tv = _inputs(bits, n, d, q, seed=bits + d + q)
    if kind == "segmin":
        out = scan.segmin_fp32(tq, tc, tn, tv, bits=bits, metric="cosine",
                               seg=32)
        assert out.shape == (q, n // 32)
    else:
        out = scan.surface_fp32(tq, tc, tn, tv, bits=bits,
                                metric="euclidean", exact=False)
        assert out.dtype == torch.bfloat16 and out.shape == (q, n)
    (c,) = entry.calls
    tile = scan.fp32_query_tile(q)
    k_dims = 2 * tc.shape[1] if bits == 4 else d
    assert (c["q"], c["n"], c["tile"]) == (q, n, tile)
    assert c["qp"] == _padded(q, tile)
    assert c["kp"] % scan.FP32_K_PAD == 0
    assert 0 <= c["kp"] - k_dims < scan.FP32_K_PAD
    # the queries, transposed, zero past Q and past the decoded dims (the
    # 4-bit pad nibble meets a zero)
    want = np.zeros((c["kp"], c["qp"]), dtype=np.float32)
    want[:d, :q] = tq.numpy().T
    np.testing.assert_array_equal(c["qt"], want)
    assert c["bits"] == (32 if bits == 64 else bits)
    assert c["row_bytes"] == tc.shape[1] * tc.element_size()
    assert c["vec"] in (16, 8, 4, 2, 1)
    assert c["row_bytes"] % c["vec"] == 0 and c["codes"] % c["vec"] == 0
    assert c["cosine"] == int(kind == "segmin")
    assert c["last"] == (32 if kind == "segmin" else 1)
    if bits in (4, 8, 16):
        assert (c["scale"], c["offset"]) == pytest.approx(
            scan.qz.affine_constants(bits))
    else:
        assert (c["scale"], c["offset"]) == (1.0, 0.0)


@pytest.mark.parametrize("tile", scan.FP32_TILES)
def test_fp32_launch_takes_any_built_tile(entry, tile):
    """Every tile is a launch parameter only: the card's tile sweep pins
    one through _launch_fp32, and Q pads to a multiple of it."""
    tq, tc, tn, tv = _inputs(16, 512, 40, 20, seed=tile)
    out = torch.empty((20, 512 // 64))
    scan._launch_fp32("segmin", out, 64, tq, tc, tn, tv, bits=16,
                      metric="euclidean", tile=tile)
    (c,) = entry.calls
    assert (c["tile"], c["qp"], c["last"]) == (tile, _padded(20, tile), 64)


def test_fp32_launch_refuses_unbuilt_tiles_and_segments(entry):
    tq, tc, tn, tv = _inputs(32, 256, 16, 3, seed=0)
    with pytest.raises(ValueError, match="query tiles"):
        scan._launch_fp32("segmin", torch.empty((3, 8)), 32, tq, tc, tn, tv,
                          bits=32, metric="cosine", tile=48)
    with pytest.raises(ValueError, match="query tiles"):
        scan._launch_fp32("surface", torch.empty((3, 256)), 0, tq, tc, tn,
                          tv, bits=32, metric="cosine", tile=256)
    with pytest.raises(ValueError, match="16, 32, 64, 128"):
        scan.segmin_fp32(tq, tc, tn, tv, bits=32, metric="cosine", seg=8)
    assert entry.calls == []


@pytest.mark.parametrize("defines", [(), (("SCAN_TILE_SPLIT", 1),)])
def test_fp32_launch_loads_the_build_it_is_given(monkeypatch, defines):
    """A measurement build (tools/fp32_split.py) is launched through the
    same wrapper code as the shipped one: _launch_fp32 asks cuda_build for
    the library built with its defines; the public wrappers for the
    shipped one."""
    asked, fake = [], _Entry()

    def entry(name, symbol, argtypes, defines=()):
        asked.append((name, symbol, defines))
        return fake

    monkeypatch.setattr(cuda_build, "entry", entry)
    monkeypatch.setattr(cuda_build, "launch_stream", lambda device: 0)
    tq, tc, tn, tv = _inputs(64, 256, 16, 5, seed=1)
    scan._launch_fp32("segmin", torch.empty((5, 8)), 32, tq, tc, tn, tv,
                      bits=64, metric="cosine", defines=defines)
    scan.surface_fp32(tq, tc, tn, tv, bits=64, metric="cosine", exact=True)
    assert asked == [("segmin", "segmin_launch", defines),
                     ("surface", "surface_launch", ())]


def test_cuda_build_variants_have_their_own_library(monkeypatch):
    """cuda_build builds a variant with its defines on nvcc's command line
    into a subdirectory of _build/, beside the shipped library, so the two
    never overwrite one another."""
    shipped = cuda_build._lib_path("segmin")
    split = cuda_build._lib_path("segmin", (("SCAN_TILE_SPLIT", 2),))
    assert shipped == f"{cuda_build.BUILD_DIR}/libsegmin.so"
    assert split.startswith(cuda_build.BUILD_DIR + "/") and split != shipped
    assert split.endswith("/libsegmin.so")
    cmds = []

    class Popen:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)

    monkeypatch.setattr(cuda_build.subprocess, "Popen", Popen)
    monkeypatch.setattr(cuda_build.os, "makedirs", lambda *a, **k: None)
    for defines in ((), (("SCAN_TILE_SPLIT", 2),)):
        _, tmp = cuda_build._start("segmin", defines)
        assert tmp.startswith(cuda_build._lib_path("segmin", defines))
    assert "-DSCAN_TILE_SPLIT=2" in cmds[1]
    assert not any(c.startswith("-D") for c in cmds[0])
    # every flag but the define is the shipped build's
    assert [c for c in cmds[1] if not c.startswith("-D")
            and not c.endswith(f".tmp.{cuda_build.os.getpid()}")] == \
        [c for c in cmds[0]
         if not c.endswith(f".tmp.{cuda_build.os.getpid()}")]


def test_fp32_copy_width_follows_row_alignment(entry):
    """Rows whose length or start is not a multiple of 16 bytes take
    narrower copies: the kernel never reads across a row's end."""
    widths = {}
    for bits, d in ((16, 33), (32, 33), (8, 33), (4, 33), (16, 40),
                    (32, 384), (4, 383)):
        tq, tc, tn, tv = _inputs(bits, 64, d, 2, seed=d)
        scan.segmin_fp32(tq, tc, tn, tv, bits=bits, metric="cosine", seg=32)
        widths[(bits, d)] = (entry.calls[-1]["row_bytes"],
                             entry.calls[-1]["vec"])
    assert widths[(16, 33)] == (66, 2)
    assert widths[(32, 33)] == (132, 4)
    assert widths[(8, 33)] == (33, 1)
    assert widths[(4, 33)] == (17, 1)
    assert widths[(16, 40)] == (80, 16)
    assert widths[(32, 384)] == (1536, 16)
    assert widths[(4, 383)] == (192, 16)


def _on_cuda(n, d):
    """Stand-in codes on a CUDA device: what _route reads of them."""
    return types.SimpleNamespace(device=torch.device("cuda"), shape=(n, d))


@pytest.mark.parametrize("bits", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("d", [33, 384, 511, 512, 960, 992, 993, 1536])
@pytest.mark.parametrize("q", [1, 16, 17, 1024])
def test_route_by_width_kernel_and_shape(bits, d, q, monkeypatch):
    """K1 and K5/K6 ("segmin") take the int8 route at 8 bits and at 16
    bits up to hilo_max_dims (the kernel library's answer, 992 on the
    H100) but for batches of at most 16 queries on rows narrower than 512,
    K4 ("surface") at 8 bits alone; every other width and shape the fp32
    kernels; CPU tensors the plain versions."""
    monkeypatch.setattr(scan, "hilo_max_dims", lambda device: 992)
    codes = _on_cuda(1024, d)
    want_segmin = "i8" if bits == 8 or (
        bits == 16 and d <= 992 and (q > 16 or d >= 512)) else "fp32"
    assert scan._route(codes, bits, "segmin", q) == want_segmin
    assert scan._route(codes, bits, "surface", q) == \
        ("i8" if bits == 8 else "fp32")
    cpu = torch.zeros((4, d), dtype=scan._CODE_DTYPES[bits])
    assert scan._route(cpu, bits, "segmin", q) == "plain"
    assert scan._route(cpu, bits, "surface", q) == "plain"


class _I8Entry:
    """Stand-in for csrc/segmin_i8.cu's entry points: records the
    arguments and copies the slices out while the wrapper holds them."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        (slices, qscale, codes, norms, valid, qn2, qsum, out, q, n, d, kp,
         bits, cosine, scale, offset, last, vec, stream) = args
        buf = (ctypes.c_int8 * (3 * q * kp)).from_address(slices)
        self.calls.append(dict(
            slices=np.ctypeslib.as_array(buf).reshape(3, q, kp).copy(),
            codes=codes, norms=norms, valid=valid, q=q, n=n, d=d, kp=kp,
            bits=bits, cosine=cosine, scale=scale, offset=offset, last=last,
            vec=vec))
        return 0


@pytest.fixture
def i8_entry(monkeypatch):
    fake = _I8Entry()
    monkeypatch.setattr(cuda_build, "entry", lambda *a, **k: fake)
    monkeypatch.setattr(cuda_build, "launch_stream", lambda device: 0)
    return fake


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("seg", [16, 32, 128])
@pytest.mark.parametrize("n,d,q", [(1024, 33, 3), (512, 960, 17),
                                   (256, 40, 1)])
def test_i8_launch_operands(i8_entry, bits, seg, n, d, q):
    """segmin_i8_launch gets slice_queries' slices (at 16 bits in
    hilo_order), Kp = D rounded up to 32, the codes' width, their copy
    width from the row's bytes, the affine constants and the segment; the
    launch counters rise, i8_hilo_launches at 16 bits alone."""
    tq, tc, tn, tv = _inputs(bits, n, d, q, seed=bits + d + seg)
    before = (scan.launches, scan.free_seg_launches, scan.i8_launches,
              scan.i8_free_seg_launches, scan.i8_hilo_launches)
    out, dq = scan._segmin_i8(tq, tc, tn, tv, bits=bits, metric="euclidean",
                              seg=seg)
    assert out.shape == (q, n // seg)
    (c,) = i8_entry.calls
    slices, _, want_dq = scan.slice_queries(tq)
    assert torch.equal(dq, want_dq)
    if bits == 16:
        slices = scan.hilo_order(slices)
    np.testing.assert_array_equal(c["slices"], slices.numpy())
    assert (c["q"], c["n"], c["d"], c["bits"], c["last"]) == \
        (q, n, d, bits, seg)
    assert c["kp"] == -(-d // 32) * 32
    assert (c["scale"], c["offset"]) == pytest.approx(
        scan.qz.affine_constants(bits))
    assert c["cosine"] == 0
    row_bytes = d * tc.element_size()
    assert c["vec"] == next(v for v in (16, 4, 1) if row_bytes % v == 0)
    k1 = seg == scan.DEFAULT_SEG
    assert (scan.launches, scan.free_seg_launches, scan.i8_launches,
            scan.i8_free_seg_launches, scan.i8_hilo_launches) == (
        before[0] + k1, before[1] + (not k1), before[2] + k1,
        before[3] + (not k1), before[4] + (bits == 16))


def test_hilo_order_is_a_permutation_within_each_32_block():
    """hilo_order permutes each 32-dim block of K by one fixed permutation
    (slot p <- dim (p & 16) + 8 bit1(p) + 2 ((p >> 2) & 3) + bit0(p)), so
    the slices' dot with codes in the same order is unchanged."""
    kp = 96
    x = torch.arange(kp, dtype=torch.int8).repeat(3, 2, 1)
    got = scan.hilo_order(x)[0, 0].tolist()
    p = np.arange(32)
    blk = (p & 16) + 8 * ((p >> 1) & 1) + 2 * ((p >> 2) & 3) + (p & 1)
    assert got == [b * 32 + int(i) for b in range(3) for i in blk]
    assert sorted(blk.tolist()) == list(range(32))
    assert torch.equal(scan.hilo_order(x)[2, 1], scan.hilo_order(x)[0, 0])

"""The port's sketch index and Hamming surface (syzgydb_tpu_torch/index/
hamming.py, ops/hamming_scan.py) against the JAX package's.

Sketch bits and Hamming counts are integers: both compare bit for bit,
the f32 and bf16 surfaces of K2 (hamming_scores) and the uint8 surface of
K3 (hamming_scores_u8, which wraps a count of 256 to 0 as the JAX
function's uint8 cast does).  On the card both are int8 tensor-core
products of unpacked sketch bits (csrc/hamming.cu); _emulate_tc_hamming
repeats that arithmetic, with the kernel's bit -> k mapping, in integers
here, against the JAX kernels in interpret mode.
Candidate SETS are not compared — the JAX package selects with
approx_min_k (recall_target 0.95) where the port takes an exact topk — so
the selection is held to recall instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syzgydb_tpu.index import hamming as jham
from syzgydb_tpu.ops import distance as jdist
from syzgydb_tpu.ops import pallas_hamming as jph
from syzgydb_tpu.utils.rng import MyRandom as JRandom
from syzgydb_tpu_torch.index import hamming as tham
from syzgydb_tpu_torch.ops import distance as tdist
from syzgydb_tpu_torch.ops import hamming_scan
from syzgydb_tpu_torch.utils.rng import MyRandom as TRandom


def _indexes(dims, metric, seed=1234):
    return (jham.SignHashIndex(dims, metric, JRandom(seed)),
            tham.SignHashIndex(dims, metric, TRandom(seed)))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("bits", [4, 8, 16, 32, 64])
def test_sketches_bit_identical(bits, metric):
    dims = 47 if bits == 4 else 48
    rng = np.random.default_rng(5)
    db = rng.uniform(-1, 1, size=(2000, dims))
    ji, ti = _indexes(dims, metric)
    np.testing.assert_array_equal(ti.planes, ji.planes)
    sample = db[:512]
    ji.calibrate(sample)
    ti.calibrate(sample)
    np.testing.assert_array_equal(ti.offsets, ji.offsets)
    _, codes, _ = tdist.ingest_reprs(db, bits)
    dev_codes = np.float32(codes) if bits == 64 else codes
    seen = np.float32(
        tdist.qz.device_repr_to_float(codes, bits, dims))
    np.testing.assert_array_equal(ti.encode_np(seen), ji.encode_np(seen))
    want = np.asarray(ji.encode_codes_device(jnp.asarray(dev_codes), bits))
    got = ti.encode_codes_device(torch.from_numpy(dev_codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_encode_codes_device_chunks(monkeypatch):
    rng = np.random.default_rng(6)
    db = rng.uniform(-1, 1, size=(1000, 32))
    _, codes, _ = tdist.ingest_reprs(db, 8)
    _, ti = _indexes(32, "cosine")
    whole = ti.encode_codes_device(torch.from_numpy(codes), 8)
    monkeypatch.setattr(tham.SignHashIndex, "ENCODE_CHUNK_ROWS", 128)
    chunked = ti.encode_codes_device(torch.from_numpy(codes), 8)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())


@pytest.mark.parametrize("words", [1, 5, 7])
def test_plain_hamming_matches_jax_kernel(words):
    rng = np.random.default_rng(7)
    q, n = 6, 1024
    qcodes = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    hashes = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    hashes[3] = qcodes[0]  # distance 0
    hashes[4] = ~qcodes[1]  # distance 32 * words
    valid = np.ones(n, dtype=bool)
    valid[rng.choice(n, 50, replace=False)] = False
    want = np.asarray(jph.hamming_scores_bf16(
        jnp.asarray(qcodes), jnp.asarray(hashes), jnp.asarray(valid),
        words=words, block_n=256, interpret=True, out_dtype=jnp.float32))
    got = hamming_scan.hamming_scores(
        torch.from_numpy(qcodes.view(np.int32)),
        torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 3] == 0.0 or not valid[3]
    assert got[1, 4] == 32 * words or not valid[4]


@pytest.mark.parametrize("words", [5, 8])
def test_plain_u8_hamming_matches_jax_kernel(words):
    rng = np.random.default_rng(17)
    q, n = 6, 2048
    qcodes = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    hashes = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    hashes[3] = qcodes[0]   # distance 0
    hashes[4] = ~qcodes[1]  # distance 32 * words: 256 at W = 8
    hashes[5] = ~qcodes[2]
    hashes[5, 0] ^= 1       # distance 32 * words - 1: 255 at W = 8
    want = np.asarray(jph.hamming_scores(
        jnp.asarray(qcodes), jnp.asarray(hashes), words=words, block_n=512,
        interpret=True))
    got = hamming_scan.hamming_scores_u8(
        torch.from_numpy(qcodes.view(np.int32)),
        torch.from_numpy(hashes.view(np.int32)))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 3] == 0
    assert int(got[1, 4]) == (32 * words) % 256
    assert int(got[2, 5]) == 32 * words - 1
    # below the wrap, K3 is K2's count with no mask
    if words < 8:
        ones = torch.ones(n, dtype=torch.bool)
        np.testing.assert_array_equal(
            got.numpy().astype(np.float32), hamming_scan.hamming_scores(
                torch.from_numpy(qcodes.view(np.int32)),
                torch.from_numpy(hashes.view(np.int32)), ones).numpy())


# csrc/hamming.cu's bit -> k mapping within a word: k = 16 h + 4 t + j
# holds bit 8 j + 4 h + t (h < 2, t < 4, j < 4)
_K_BIT = np.array([8 * (k % 4) + 4 * (k // 16) + (k % 16) // 4
                   for k in range(32)])


def _unpack_k(words: np.ndarray) -> torch.Tensor:
    """(R, W) uint32 -> (R, 32 W) int64 0/1 bits in the kernel's k order."""
    bits = (words[:, :, None] >> _K_BIT[None, None, :].astype(np.uint32)) & 1
    return torch.from_numpy(bits.reshape(len(words), -1).astype(np.int64))


def _emulate_tc_hamming(qcodes: np.ndarray, hashes: np.ndarray):
    """The kernel's arithmetic in integers: popc(q) + sum_k (1 - 2 q_k) r_k
    over the unpacked bits (an int64 matmul standing in for the int8
    mma.sync products) -> (Q, N) int64 counts."""
    qb, rb = _unpack_k(qcodes), _unpack_k(hashes)
    return qb.sum(dim=1, keepdim=True) + (1 - 2 * qb) @ rb.T


def _one_bit_rows(qcode: np.ndarray) -> np.ndarray:
    """32 W rows that each differ from `qcode` (W,) in exactly one bit, at
    every bit of every word."""
    w = len(qcode)
    rows = np.repeat(qcode[None, :], 32 * w, axis=0)
    for b in range(32 * w):
        rows[b, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return rows


def _tc_case(words: int, seed: int):
    """Queries, rows (one-bit rows of query 0, the complement of query 1,
    then random) and validity with 40 invalid rows, N = 512."""
    rng = np.random.default_rng(seed)
    q, n = 5, 512
    qcodes = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    hashes = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    hashes[:32 * words] = _one_bit_rows(qcodes[0])
    hashes[32 * words] = ~qcodes[1]  # 32 * W: 256 wraps to 0 at W = 8
    hashes[32 * words + 1] = qcodes[2]  # 0
    valid = np.ones(n, dtype=bool)
    valid[rng.choice(np.arange(32 * words + 2, n), 40, replace=False)] = False
    return qcodes, hashes, valid


@pytest.mark.parametrize("words", range(1, 9))
def test_tc_emulation_matches_jax_kernels(words):
    """The kernel's integer arithmetic (bit -> k mapping shared by A and B,
    popc(q) once per query) against the JAX K2 (bf16 and f32) and K3, bit
    for bit; each one-bit row reads 1 (a mapping that A and B did not share
    would keep the total but move single bits)."""
    qcodes, hashes, valid = _tc_case(words, 100 + words)
    counts = _emulate_tc_hamming(qcodes, hashes)
    assert (counts[0, :32 * words] == 1).all()
    assert counts[1, 32 * words] == 32 * words
    assert counts[2, 32 * words + 1] == 0
    tv = torch.from_numpy(valid)
    args = (jnp.asarray(qcodes), jnp.asarray(hashes))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        want = np.asarray(jph.hamming_scores_bf16(
            *args, jnp.asarray(valid), words=words, block_n=256,
            interpret=True, out_dtype=jdt)).astype(np.float32)
        got = torch.where(tv[None, :], counts.to(dt),
                          torch.full(counts.shape, 16384.0, dtype=dt))
        np.testing.assert_array_equal(got.float().numpy(), want)
    want = np.asarray(jph.hamming_scores(*args, words=words, block_n=256,
                                         interpret=True))
    np.testing.assert_array_equal((counts & 0xFF).to(torch.uint8).numpy(),
                                  want)
    assert int(want[1, 32 * words]) == (32 * words) % 256


@pytest.mark.parametrize("words", [1, 5, 8])
def test_plain_bf16_hamming_matches_jax_kernel(words):
    qcodes, hashes, valid = _tc_case(words, 200 + words)
    want = np.asarray(jph.hamming_scores_bf16(
        jnp.asarray(qcodes), jnp.asarray(hashes), jnp.asarray(valid),
        words=words, block_n=256, interpret=True))
    assert want.dtype == jnp.bfloat16
    got = hamming_scan.hamming_scores(
        torch.from_numpy(qcodes.view(np.int32)),
        torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(valid),
        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert (got[0, :32 * words] == 1).all()


def test_hamming_wrapper_rejects_bad_input():
    qc = torch.zeros((2, 5), dtype=torch.int32)
    h = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores(qc, h[:, :4], torch.ones(8, dtype=bool))
    with pytest.raises(TypeError):
        hamming_scan.hamming_scores(qc.to(torch.int64), h,
                                    torch.ones(8, dtype=bool))
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores(qc, h, torch.ones(7, dtype=bool))
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores_u8(qc, h[:, :4])
    with pytest.raises(TypeError):
        hamming_scan.hamming_scores_u8(qc, h.to(torch.int16))
    with pytest.raises(ValueError):
        hamming_scan.hamming_scores(qc, h, torch.ones(8, dtype=bool),
                                    out_dtype=torch.float16)


def test_candidates_and_rerank_recall_vs_jax():
    """Medium's two stages on identical sketches and codes: the port's
    exact selection must recall the true top-10 at least as well as the
    JAX package's approximate one, and its candidates must be the rows of
    least Hamming distance on the bf16 surface it selects from."""
    rng = np.random.default_rng(8)
    n, dims, q, budget, k = 8192, 64, 8, 512, 10
    centers = rng.standard_normal((64, dims))
    db = centers[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal(
        (n, dims))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    queries = np.float32(db[rng.integers(0, n, q)] +
                         0.05 * rng.standard_normal((q, dims)))
    _, codes, norms = tdist.ingest_reprs(db, 8)
    valid = np.ones(n, dtype=bool)
    valid[::97] = False
    ji, ti = _indexes(dims, "cosine")
    hashes = np.array(ji.encode_codes_device(jnp.asarray(codes), 8))
    qcode = ji.encode_np(queries)

    _, jcand = jham._hamming_candidates_xla(
        jnp.asarray(qcode), jnp.asarray(hashes), jnp.asarray(valid), budget,
        ji.words)
    jd, jr = jham.rerank_topk(jnp.asarray(queries), jnp.asarray(codes),
                              jnp.asarray(norms), jnp.asarray(valid), jcand,
                              8, "cosine", k)

    tq = torch.from_numpy(queries)
    th = torch.from_numpy(hashes.view(np.int32))
    tv = torch.from_numpy(valid)
    hvals, tcand = tham.hamming_candidates(
        torch.from_numpy(qcode.view(np.int32)), th, tv, budget)
    assert hvals.dtype == torch.bfloat16
    surface = hamming_scan.hamming_scores(
        torch.from_numpy(qcode.view(np.int32)), th, tv,
        out_dtype=torch.bfloat16)
    kth = torch.kthvalue(surface.float(), budget, dim=1).values
    assert (hvals.float().max(dim=1).values == kth).all()
    td, tr, cnt = tham.rerank_topk(tq, torch.from_numpy(codes),
                                   torch.from_numpy(norms), tv, tcand, 8,
                                   "cosine", k, with_counts=True)
    assert (cnt <= budget).all() and (cnt > 0).all()

    exact = jdist.score_block(jnp.asarray(queries), jnp.asarray(codes),
                              jnp.asarray(norms), jnp.asarray(valid), 8,
                              "cosine", exact=True)
    truth = np.asarray(jdist.top_k_smallest(exact, k)[1])
    exact = np.asarray(exact)

    def recall(rows):
        return np.mean([len(set(rows[i]) & set(truth[i].tolist())) / k
                        for i in range(q)])

    assert recall(tr.numpy()) >= recall(np.asarray(jr)) - 1e-9
    assert recall(tr.numpy()) >= 0.9
    # the port's reranked distances are the full-scan distances of the
    # rows it returns, up to f32 summation order (~1e-7 on the cosine,
    # which acos at these angles amplifies about 2x)
    np.testing.assert_allclose(
        td.numpy(), np.take_along_axis(exact, tr.numpy(), 1), atol=1e-6)

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (syzgydb_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a: H100/H200) and nvcc.  It imports nothing of
JAX or of the JAX package.  Phases, each of which fails the run:

  1. device: requires torch.cuda.is_available(); prints the card's name and
     power limit (nvidia-smi).
  2. kernels: builds csrc/*.cu (one nvcc per source, in parallel) and holds
     each kernel against its plain PyTorch version on the card, at 65,536
     rows x 384 dims (383 at 4-bit) with zero and invalid rows: K1
     (segment min, seg 32) at Q in {64, 1024}, every width, both metrics,
     K5/K6 (seg 16, 64, 128) and K4 (the full surface, f32 and bf16) at
     every width, within the completeness flag's own error bound of an f64
     evaluation (bf16: plus half an ulp).  On 8-bit codes all three run the
     int8 route (csrc/segmin_i8.cu), held with its query-slicing error
     dq_rel in that bound and also within 4 f32 ulps of the surrogate's
     terms of an f64 evaluation on its sliced queries q_hat: K1 and K5/K6
     at both metrics and Q in {64, 1024}, K4 at both metrics and Q in
     {8, 128}.  K2 (Hamming, f32 and bf16) and K3 (Hamming, uint8,
     wrapping at 256) bit for bit at W = 1..8 with Q and N tails and rows
     one bit away from a query at every bit.
  3. main path: a 1,000,000 x 384 cosine 8-bit collection of clustered unit
     vectors made from a seed, ingested through Collection.add_documents
     with metadata {"i": n}, queried with search_many at precision high
     (batch 1024), exact (batch 8), medium (batch 64, and batch 8 below the
     scan crossover) and one plain search(); then radius search (high
     batch 8 escalating past 1024 rows into the non-fused K4 branch,
     radius_many batch 128 on K4 from its first dispatch, exact and medium
     batch 8), filtered kNN (high batch 1024, medium batch 8, with a broad
     and a selective filter), a filtered radius search, and the ops entry
     points of K5/K6 (fused_scan_topk at seg 64) and K3 on the collection's
     state.  Results are held against an independent fp64 oracle on the
     card, and every kernel's launch counter must rise; every 8-bit high
     and exact phase that scans must run K1's int8 route and never the
     fp32 kernel at seg 32; both radius phases must run K4's int8 route,
     the seg-64 ops phase K5/K6's, and the fp32 K4 and K5/K6 kernels must
     launch nowhere.
  4. kernels at the main path's shapes: all six on the ingested state held
     against their plain versions as in phase 2, then timed beside the
     plain versions, a library call and their bounds on the H100 (K1 at
     Q = 1024, 64 and 8, K4 f32 at Q = 128 and 8, K5/K6 at seg 16, 64 and
     128 and Q = 1024, each beside its 3-slice int8 floor, and the fp32
     kernels of K1, K4 and K5/K6 at one shape each; K2 in bf16 and f32 at
     Q = 8 and 1 and K3 at Q = 64, beside torch._int_mm on pre-unpacked
     bits);
     end-to-end ms per batch and QPS; the first filter mask's build time;
     the radius group's device transient against core/capacity.py's
     estimate.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bytes/s and the rates bounds use
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

N_ROWS, DIMS, K = 1_000_000, 384, 10
N_CENTERS = 4096


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call over `reps` calls, timed with CUDA events.
    A ~10 ms spin kernel queued first keeps the card busy while the host
    queues every call, so a call shorter than its own launch overhead is
    timed by the card, not by the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1000.0)
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def segmin_error(got, want, qn2, norms, valid, metric, dims, what,
                 dq_rel=None):
    """Segment minima (K1, K5/K6) against the plain version in f64:
    identical +inf positions and every finite error within the completeness
    flag's own bound (surface_delta, with the int8 route's dq_rel where
    given).  Returns (max |err|, max err/bound)."""
    from syzgydb_tpu_torch.ops import scan

    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"segment minima: +inf positions differ: "
                             f"{what}")
    delta = scan.surface_delta(qn2, norms, valid, metric=metric, dims=dims,
                               dq_rel=dq_rel, bits=8
                               ).to(torch.float64)[:, None]
    err = (got.double() - want).abs()
    err = torch.where(torch.isinf(want), torch.zeros_like(err), err)
    ratio = float((err / delta).max())
    if ratio > 1.0:
        raise AssertionError(f"segment minima off the plain version by "
                             f"{ratio:.3g} x delta: {what}")
    return float(err.max()), ratio


def i8_checks(got, tq, codes, norms, valid, metric, dims, what,
              seg=32, bf16=False):
    """The int8 route (8-bit codes: K1 at seg 32, K5/K6 at seg 16/64/128,
    K4's surface for seg=None, bf16 or f32) held both ways: within
    surface_delta (with slice_queries' dq_rel) of the f64 plain version on
    the unrounded queries, and within 4 f32 ulps of the surrogate's terms
    (i8_term_scale) of the f64 plain version on the sliced queries q_hat
    with the unrounded |q|^2 and sum; identical +inf positions; bf16 plus
    half an ulp of the value each way.  Returns (max |err| vs the unrounded
    queries, max err/delta, max err/ulp bound)."""
    from syzgydb_tpu_torch.ops import scan

    def plain(q, terms=None):
        if seg is None:
            return scan.score_surface_plain(q, codes, norms, valid, bits=8,
                                            metric=metric,
                                            dtype=torch.float64,
                                            query_terms=terms)
        return scan.segment_min_scan_plain(q, codes, norms, valid, bits=8,
                                           metric=metric, seg=seg,
                                           dtype=torch.float64,
                                           query_terms=terms)

    qn2 = tq.square().sum(-1)
    slices, scale, dq_rel = scan.slice_queries(tq)
    want = plain(tq)
    if seg is None:
        err, ratio = surface_error(got, want, qn2, norms, valid, metric, dims,
                                   what, bf16, dq_rel=dq_rel)
    else:
        err, ratio = segmin_error(got, want, qn2, norms, valid, metric, dims,
                                  what, dq_rel=dq_rel)
    del want
    qhat = scan.unslice_queries(slices, scale)[:, :dims]
    tight = plain(qhat, (qn2, tq.sum(-1)))
    got = got.double()
    if not torch.equal(torch.isinf(got), torch.isinf(tight)):
        raise AssertionError(f"int8 route: +inf positions differ on q_hat: "
                             f"{what}")
    tol = 4 * 2.0 ** -24 * scan.i8_term_scale(
        qn2, norms, valid, metric=metric, dims=dims).double()[:, None]
    fin = torch.isfinite(tight)
    zero = torch.zeros_like(tight)
    e = torch.where(fin, (got - tight).abs(), zero)
    if bf16:
        tol = tol + half_ulp_bf16(torch.where(
            fin, torch.maximum(tight.abs(), got.abs()), zero))
    ulp_ratio = float((e / tol).max())
    if ulp_ratio > 1.0:
        raise AssertionError(f"int8 route off the f64 evaluation on q_hat by "
                             f"{ulp_ratio:.3g} x its ulp bound: {what}")
    return err, ratio, ulp_ratio


def half_ulp_bf16(x):
    """Half a bf16 unit in the last place at |x| (8 significant bits)."""
    a = x.abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(
        a.clamp_min(1e-30))) - 8), torch.zeros_like(a))


def surface_error(got, want, qn2, norms, valid, metric, dims, what,
                  bf16: bool, dq_rel=None):
    """K4's surface against the plain version in f64: identical +inf
    positions, every finite error within surface_delta (with the int8
    route's dq_rel where given; bf16: plus half an ulp of the value).
    Returns (max |err|, max err/bound)."""
    from syzgydb_tpu_torch.ops import scan

    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"K4 +inf positions differ: {what}")
    bound = scan.surface_delta(qn2, norms, valid, metric=metric, dims=dims,
                               dq_rel=dq_rel, bits=8
                               ).to(torch.float64)[:, None]
    fin = torch.isfinite(want)
    zero = torch.zeros_like(want)
    want = torch.where(fin, want, zero)
    got = torch.where(fin, got.double(), zero)
    if bf16:
        # the larger magnitude's half ulp: the two may straddle a power of 2
        bound = bound + half_ulp_bf16(torch.maximum(want.abs(), got.abs()))
    err = (got - want).abs()
    ratio = float((err / bound).max())
    if ratio > 1.0:
        raise AssertionError(f"K4 off its plain version by {ratio:.3g} x "
                             f"its bound: {what}")
    return float(err.max()), ratio


def u8_abs_err(got, want) -> int:
    """Largest |got - want| of two uint8 count surfaces, taken in int32."""
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def i8_free_and_surface(tq_all: dict, tc, tn, tv, d: int) -> dict:
    """The int8 route's K5/K6 (seg 16/64/128, both metrics, Q = 64 and
    1024) and K4 (f32 and bf16, both metrics, Q = 8 and 128) on 8-bit
    codes, each held by i8_checks."""
    from syzgydb_tpu_torch.ops import scan

    out = {"free_err": 0.0, "free_ratio": 0.0, "free_runs": 0,
           "surf_err": 0.0, "surf_ratio": 0.0, "surf_runs": 0, "ulp": 0.0}
    for q in (64, 1024):
        tq = tq_all[q]
        for seg in (16, 64, 128):
            for metric in ("euclidean", "cosine"):
                got = scan.segment_min_scan(tq, tc, tn, tv, bits=8,
                                            metric=metric, seg=seg)
                err, ratio, ulps = i8_checks(
                    got, tq, tc, tn, tv, metric, d,
                    f"seg {seg} 8-bit {metric} Q={q}", seg=seg)
                out["free_err"] = max(out["free_err"], err)
                out["free_ratio"] = max(out["free_ratio"], ratio)
                out["ulp"] = max(out["ulp"], ulps)
                out["free_runs"] += 1
    tq = tq_all[1024]
    for q in (8, 128):
        qq = tq[:q].contiguous()
        for metric in ("euclidean", "cosine"):
            for exact in (True, False):
                got = scan.score_surface(qq, tc, tn, tv, bits=8,
                                         metric=metric, exact=exact)
                err, ratio, ulps = i8_checks(
                    got, qq, tc, tn, tv, metric, d,
                    f"K4 8-bit {metric} Q={q} exact={exact}", seg=None,
                    bf16=not exact)
                # max |err| and the ulp ratio are the f32 surface's: the
                # bf16 one adds its rounding (its bound, half an ulp, is
                # met with ratios near 1 by construction)
                if exact:
                    out["surf_err"] = max(out["surf_err"], err)
                    out["ulp"] = max(out["ulp"], ulps)
                out["surf_ratio"] = max(out["surf_ratio"], ratio)
                out["surf_runs"] += 1
                del got
    return out


def check_kernels(dev, n: int = 65536, batches=(64, 1024)) -> dict:
    from syzgydb_tpu_torch.ops import distance as dist_ops
    from syzgydb_tpu_torch.ops import hamming_scan, scan

    rng = np.random.default_rng(2024)
    seg_err, seg_ratio, runs = 0.0, 0.0, 0
    i8_runs, i8_ulp = 0, 0.0
    free_err, free_ratio, free_runs = 0.0, 0.0, 0
    surf_err, surf_ratio, surf_runs = 0.0, 0.0, 0
    for bits in (4, 8, 16, 32, 64):
        d = DIMS - 1 if bits == 4 else DIMS
        db = rng.uniform(-1, 1, size=(n, d))
        db[rng.choice(n, 64, replace=False)] = 0.0
        _, codes, norms = dist_ops.ingest_reprs(db, bits)
        if bits == 64:
            codes = np.float32(codes)
        valid = np.ones(n, dtype=bool)
        valid[rng.choice(n, 500, replace=False)] = False
        valid[32 * 5:32 * 6] = False  # one wholly invalid segment
        valid[128 * 4:128 * 5] = False  # and one at every segment length
        tc = torch.from_numpy(codes).to(dev)
        tn = torch.from_numpy(norms).to(dev)
        tv = torch.from_numpy(valid).to(dev)
        tq_all = {}
        for q in batches:
            qv = np.float32(rng.uniform(-1, 1, size=(q, d)))
            qv[0] = 0.0
            tq = tq_all[q] = torch.from_numpy(qv).to(dev)
            qn2 = tq.square().sum(-1)
            for metric in ("euclidean", "cosine"):
                got = scan.segment_min_scan(tq, tc, tn, tv, bits=bits,
                                            metric=metric)
                what = f"{bits}-bit {metric} Q={q}"
                if bits == 8:  # K1's int8 route
                    err, ratio, ulps = i8_checks(got, tq, tc, tn, tv,
                                                 metric, d, what)
                    i8_ulp = max(i8_ulp, ulps)
                    i8_runs += 1
                else:
                    want = scan.segment_min_scan_plain(
                        tq, tc, tn, tv, bits=bits, metric=metric,
                        dtype=torch.float64)
                    err, ratio = segmin_error(got, want, qn2, tn, tv,
                                              metric, d, what)
                    del want
                seg_err = max(seg_err, err)
                seg_ratio = max(seg_ratio, ratio)
                runs += 1
        if bits == 8:  # the int8 route: K5/K6 and K4 held both ways
            i8 = i8_free_and_surface(tq_all, tc, tn, tv, d)
            free_err, free_ratio = max(free_err, i8["free_err"]), max(
                free_ratio, i8["free_ratio"])
            surf_err, surf_ratio = max(surf_err, i8["surf_err"]), max(
                surf_ratio, i8["surf_ratio"])
            free_runs += i8["free_runs"]
            surf_runs += i8["surf_runs"]
            i8_ulp = max(i8_ulp, i8["ulp"])
            i8_runs += i8["free_runs"] + i8["surf_runs"]
            del tc, tn, tv
            continue
        # K5/K6: the segment-min kernel at the other segment lengths
        tq = tq[:64].contiguous()
        qn2 = tq.square().sum(-1)
        for seg, metric in ((16, "cosine"), (64, "euclidean"),
                            (128, "cosine")):
            want = scan.segment_min_scan_plain(
                tq, tc, tn, tv, bits=bits, metric=metric, seg=seg,
                dtype=torch.float64)
            got = scan.segment_min_scan(tq, tc, tn, tv, bits=bits,
                                        metric=metric, seg=seg)
            err, ratio = segmin_error(got, want, qn2, tn, tv, metric, d,
                                      f"seg {seg} {bits}-bit {metric}")
            free_err, free_ratio = max(free_err, err), max(free_ratio, ratio)
            free_runs += 1
        # K4: the full surface, f32 and bf16
        for metric in ("euclidean", "cosine"):
            want = scan.score_surface_plain(tq, tc, tn, tv, bits=bits,
                                            metric=metric,
                                            dtype=torch.float64)
            for exact in (True, False):
                got = scan.score_surface(tq, tc, tn, tv, bits=bits,
                                         metric=metric, exact=exact)
                err, ratio = surface_error(
                    got, want, qn2, tn, tv, metric, d,
                    f"{bits}-bit {metric} exact={exact}", not exact)
                # max |err| is the f32 surface's: the bf16 one adds its
                # rounding (up to 1.0 at euclidean values near 512)
                if exact:
                    surf_err = max(surf_err, err)
                surf_ratio = max(surf_ratio, ratio)
                surf_runs += 1
            del want, got
        del tc, tn, tv
    log(f"K1: {runs} configurations within delta of f64 "
        f"(max |err| {seg_err:.3g}, max err/delta {seg_ratio:.3g}); the "
        f"{i8_runs} 8-bit K1, K5/K6 and K4 ones (int8 route) also within 4 "
        f"ulps on q_hat (max err/bound {i8_ulp:.3g}, f32 outputs)")
    log(f"K5/K6 (seg 16/64/128): {free_runs} configurations within delta "
        f"of f64 (max |err| {free_err:.3g}, max err/delta "
        f"{free_ratio:.3g})")
    log(f"K4: {surf_runs} configurations within their bound of f64 (f32 "
        f"max |err| {surf_err:.3g}, max err/bound {surf_ratio:.3g})")

    ham_err, u8_err, ham_runs = check_hamming(dev, rng)
    log(f"K2 (f32 and bf16) and K3: bit-exact against their plain versions "
        f"in {ham_runs} configurations (W = 1..8, Q and N tails, one-bit "
        f"rows, invalid rows, the W=8 wrap)")
    return {"segmin": seg_err, "hamming": ham_err, "free_seg": free_err,
            "surface": surf_err, "hamming_u8": u8_err,
            "segmin_i8_ulp_ratio": i8_ulp}


def check_hamming(dev, rng, n: int = 65533):
    """K2 (f32 and bf16) and K3 against their plain versions, bit for bit,
    at W = 1..8 and Q in {1, 7, 64, 129} on N rows (a tail past every
    16-row tile and 16-byte run), with rows one bit away from query 0 at
    every bit (each must read 1: the kernel's bit -> k mapping), the
    complement of query 1 (32 W: 256 wraps to 0 in K3 at W = 8) and 1%
    invalid rows.  -> (K2 max |err|, K3 max |err|, configurations)."""
    from syzgydb_tpu_torch.ops import hamming_scan

    ham_err, u8_err, runs = 0.0, 0, 0
    for w in range(1, 9):
        h = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
        valid = rng.random(n) > 0.01
        tv = torch.from_numpy(valid).to(dev)
        for q in (1, 7, 64, 129):
            qc = rng.integers(0, 2**32, size=(q, w), dtype=np.uint32)
            for b in range(32 * w):
                h[b] = qc[0]
                h[b, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
            if q > 1:
                h[32 * w] = ~qc[1]
            tqc = torch.from_numpy(qc.view(np.int32)).to(dev)
            th = torch.from_numpy(h.view(np.int32)).to(dev)
            what = f"W={w}, Q={q}, N={n}"
            for dt in (torch.float32, torch.bfloat16):
                got = hamming_scan.hamming_scores(tqc, th, tv, out_dtype=dt)
                want = hamming_scan.hamming_scores_plain(tqc, th, tv,
                                                         out_dtype=dt)
                if got.dtype != dt or not torch.equal(got, want):
                    raise AssertionError(f"K2 ({dt}) differs from its plain "
                                         f"version ({what})")
                ham_err = max(ham_err, float((got.float() - want.float())
                                             .abs().max()))
                ones = got[0, :32 * w][tv[:32 * w]]
                if not bool((ones == 1).all()):
                    raise AssertionError(f"K2 ({dt}): a one-bit row does not "
                                         f"read 1 ({what})")
            got = hamming_scan.hamming_scores_u8(tqc, th)
            want = hamming_scan.hamming_scores_u8_plain(tqc, th)
            u8_err = max(u8_err, u8_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K3 differs from its plain version "
                                     f"({what})")
            if not bool((got[0, :32 * w] == 1).all()):
                raise AssertionError(f"K3: a one-bit row does not read 1 "
                                     f"({what})")
            if q > 1 and int(got[1, 32 * w]) != (32 * w) % 256:
                raise AssertionError(f"K3 count at W={w} does not wrap as "
                                     f"the TPU kernel's uint8 cast")
            runs += 3
    return ham_err, float(u8_err), runs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_corpus(seed: int = 12345):
    """Clustered unit vectors (4096 centres, spread 0.35) and noisy queries
    near stored rows — the shape of text-embedding corpora."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CENTERS, DIMS), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, N_CENTERS, size=N_ROWS)
    db = rng.standard_normal((N_ROWS, DIMS), dtype=np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    db *= 0.35
    db += centers[assign]
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    qrng = np.random.default_rng(777)
    noise = qrng.standard_normal((1024, DIMS)).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    queries = db[qrng.integers(0, N_ROWS, size=1024)] + 0.2 * noise
    queries = np.float32(queries / np.linalg.norm(queries, axis=1,
                                                  keepdims=True))
    return db, queries


def oracle_vectors(coll, dev):
    """The stored rows dequantized in fp64 on the card with the reference
    formula (code/255)*2-1 and normalized, their validity, and their ids."""
    size = coll.columns.size
    codes = torch.from_numpy(coll.columns.codes[:size]).to(dev)
    v = ((codes.to(torch.float64) + 128.0) / 255.0) * 2.0 - 1.0
    v = v / v.norm(dim=1, keepdim=True)
    valid = torch.from_numpy(coll.columns.valid[:size]).to(dev)
    ids = torch.from_numpy(coll.columns.ids[:size].astype(np.int64)).to(dev)
    return v, valid, ids


def oracle_dists(oracle, queries: np.ndarray, keep=None):
    """(Q, N) fp64 angular distances acos(cos)/pi of the queries to every
    stored row, +inf off the validity column (and off the row mask
    `keep`)."""
    v, valid, _ = oracle
    q = torch.from_numpy(queries).to(v.device, torch.float64)
    cos = (q / q.norm(dim=1, keepdim=True)) @ v.T
    d = torch.acos(cos.clamp_(-1.0, 1.0)).div_(np.pi)
    ok = valid if keep is None else valid & keep
    return d.masked_fill_(~ok[None, :], np.inf)


def oracle_top10(oracle, queries: np.ndarray, keep=None) -> list[set]:
    """Independent fp64 top-10 ids on the card, 128 queries at a time."""
    ids = oracle[2]
    out = []
    for a in range(0, len(queries), 128):
        d = oracle_dists(oracle, queries[a:a + 128], keep)
        rows = torch.topk(d, K, dim=1, largest=False).indices
        out += [set(r) for r in ids[rows].cpu().tolist()]
        del d
    return out


def oracle_radius(oracle, queries: np.ndarray, target: int, keep=None):
    """Per query, a radius between the oracle's r-th and (r+1)-th
    distances, r from `target` up until that gap is at least 1e-5, so no
    row lies within f32 error of the boundary; -> (radii, id sets)."""
    ids = oracle[2]
    d = oracle_dists(oracle, queries, keep)
    s, order = torch.sort(d, dim=1)
    head = s[:, :target + 4096].cpu().numpy()
    radii, sets = [], []
    for i in range(len(queries)):
        r = target
        while head[i, r] - head[i, r - 1] < 1e-5:
            r += 1
        radii.append(float((head[i, r - 1] + head[i, r]) / 2.0))
        sets.append(set(ids[order[i, :r]].cpu().tolist()))
    del d, s, order
    return radii, sets


def recall(results, truth) -> float:
    return float(np.mean([len({r.id for r in res.results} & t) / K
                          for res, t in zip(results, truth)]))


def set_recall(results, truth) -> float:
    """Mean share of each query's true id set that came back."""
    return float(np.mean([len({r.id for r in res.results} & t) / len(t)
                          for res, t in zip(results, truth)]))


def main_path(dev, report: dict):
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.core import capacity
    from syzgydb_tpu_torch.ops import hamming_scan, scan

    t0 = time.perf_counter()
    db, queries = make_corpus()
    report["data_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="syzgy_smoke_")
    coll = tdb.Collection(tdb.CollectionOptions(
        name=os.path.join(tmp, "smoke.dat"), distance_method=tdb.COSINE,
        dimension_count=DIMS, quantization=8, index_seed=4242))
    t0 = time.perf_counter()
    step = 100_000
    for a in range(0, N_ROWS, step):
        ids = list(range(a, min(a + step, N_ROWS)))
        coll.add_documents(ids, db[a:a + step],
                           [b'{"i":%d}' % i for i in ids])
    report["ingest_s"] = time.perf_counter() - t0
    del db
    log(f"ingested {N_ROWS} rows in {report['ingest_s']:.1f} s "
        f"(capacity {coll.columns.capacity})")

    # every kernel's count starts at 0 here and is read after the last
    # phase; the oracle between phases launches none of them
    scan.launches = scan.free_seg_launches = scan.surface_launches = 0
    scan.i8_launches = scan.i8_free_seg_launches = scan.i8_surface_launches = 0
    hamming_scan.launches = hamming_scan.u8_launches = 0
    counts = {}

    def counters():
        return {"segmin": scan.launches, "segmin_i8": scan.i8_launches,
                "hamming": hamming_scan.launches,
                "hamming_u8": hamming_scan.u8_launches,
                "surface": scan.surface_launches,
                "surface_i8": scan.i8_surface_launches,
                "segmin_free_seg": scan.free_seg_launches,
                "segmin_free_seg_i8": scan.i8_free_seg_launches}

    def phase(name, fn):
        c0 = counters()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        c1 = counters()
        counts[name] = {"ms": (time.perf_counter() - t) * 1000.0}
        counts[name].update({f"{k}_launches": c1[k] - c0[k] for k in c1})
        return out

    def args(qs, precision, **kw):
        return [tdb.SearchArgs(vector=q, k=K, precision=precision, **kw)
                for q in qs]

    def rargs(qs, radii, precision, **kw):
        return [tdb.SearchArgs(vector=q, radius=r, precision=precision, **kw)
                for q, r in zip(qs, radii)]

    q64 = queries[:64]
    high = phase("high_first_batch1024",
                 lambda: coll.search_many(args(queries, "high")))
    exact = phase("exact_8x8", lambda: [r for i in range(0, 64, 8)
                                        for r in coll.search_many(
                                            args(q64[i:i + 8], "exact"))])
    med64 = phase("medium_batch64",
                  lambda: coll.search_many(args(q64, "medium")))
    med8 = phase("medium_8x8", lambda: [r for i in range(0, 64, 8)
                                        for r in coll.search_many(
                                            args(q64[i:i + 8], "medium"))])
    single = phase("search_single",
                   lambda: coll.search(tdb.SearchArgs(vector=queries[0],
                                                      k=K)))

    # radius search: radii from the fp64 oracle
    oracle = oracle_vectors(coll, dev)
    rq = {"high": queries[128:136], "many": queries[:128],
          "exact": queries[136:144], "medium": queries[144:152],
          "filtered": queries[152:160]}
    # a broad filter (half the rows) and a selective one (the last 1000)
    half = N_ROWS // 2
    broad, narrow = f"i < {half}", f"i >= {N_ROWS - 1000}"
    lo_ids = torch.from_numpy(coll.columns.ids[:coll.columns.size]
                              < half).to(dev)
    radius_plan = {"high": oracle_radius(oracle, rq["high"], 2000),
                   "many": oracle_radius(oracle, rq["many"], 50),
                   "exact": oracle_radius(oracle, rq["exact"], 100),
                   "medium": oracle_radius(oracle, rq["medium"], 20),
                   "filtered": oracle_radius(oracle, rq["filtered"], 100,
                                             keep=lo_ids)}
    rad = {}
    rad["high"] = phase("radius_high_batch8", lambda: coll.radius_many(
        rargs(rq["high"], radius_plan["high"][0], "high")))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rad["many"] = phase("radius_many_batch128", lambda: coll.radius_many(
        rargs(rq["many"], radius_plan["many"][0], "high")))
    transient = torch.cuda.max_memory_allocated() - base
    rad["exact"] = phase("radius_exact_batch8", lambda: coll.radius_many(
        rargs(rq["exact"], radius_plan["exact"][0], "exact")))
    rad["medium"] = phase("radius_medium_batch8", lambda: coll.radius_many(
        rargs(rq["medium"], radius_plan["medium"][0], "medium")))

    # query-string filters
    t = time.perf_counter()
    _, n_broad = coll._filter_mask(tdb.SearchArgs(filter_query=broad))
    report["first_filter_mask_ms"] = (time.perf_counter() - t) * 1000.0
    flt = {}
    flt["high_broad"] = phase("filter_high_batch1024_broad", lambda:
                              coll.search_many(args(queries, "high",
                                                    filter_query=broad)))
    flt["high_narrow"] = phase("filter_high_batch1024_narrow", lambda:
                               coll.search_many(args(queries, "high",
                                                     filter_query=narrow)))
    flt["medium_broad"] = phase("filter_medium_batch8_broad", lambda:
                                coll.search_many(args(q64[:8], "medium",
                                                      filter_query=broad)))
    flt["medium_narrow"] = phase("filter_medium_batch8_narrow", lambda:
                                 coll.search_many(args(q64[:8], "medium",
                                                       filter_query=narrow)))
    rad["filtered"] = phase("filter_radius_high_batch8", lambda:
                            coll.radius_many(rargs(
                                rq["filtered"], radius_plan["filtered"][0],
                                "high", filter_query=broad)))

    # the ops entry points of K5/K6 and K3 on the collection's state
    state = coll._device_state()
    tq = torch.from_numpy(queries).to(dev)
    ops = {}

    def seg64_proven():
        margin = None
        while True:
            d, r, ok = scan.fused_scan_topk(
                tq, state["codes"], state["norms"], state["valid"], bits=8,
                metric="cosine", k=K, seg=64, tie_margin=margin,
                with_ties=True)
            if bool(ok.all()):
                return r, margin
            margin = coll._escalate_margin(margin)

    ops["seg64"] = phase("ops_fused_scan_seg64_batch1024", seg64_proven)
    qcode64 = torch.from_numpy(coll.index.encode_np(q64).view(
        np.int32)).to(dev)
    ops["u8"] = phase("ops_hamming_u8_batch64", lambda: (
        hamming_scan.hamming_scores_u8(qcode64, state["hashes"]),
        hamming_scan.hamming_scores(qcode64, state["hashes"],
                                    torch.ones_like(state["valid"]))))

    launches = counters()
    report["phases"] = counts
    log(f"main-path launches: {launches}; per phase: {counts}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    # every 8-bit high/exact phase that scans runs K1's int8 route, and
    # the fp32 kernel at seg 32 nowhere on the (8-bit) main path;
    # radius_many batch 128 scans with K4 alone from its first dispatch
    for name in ("high_first_batch1024", "exact_8x8", "radius_high_batch8",
                 "radius_exact_batch8", "filter_high_batch1024_broad",
                 "filter_high_batch1024_narrow", "filter_radius_high_batch8"):
        c = counts[name]
        if c["segmin_i8_launches"] == 0 or \
                c["segmin_launches"] != c["segmin_i8_launches"]:
            raise AssertionError(f"{name}: K1's int8 route not taken "
                                 f"({c})")
    if launches["segmin"] != launches["segmin_i8"]:
        raise AssertionError(f"the fp32 kernel ran at seg 32 on the 8-bit "
                             f"main path: {launches}")
    # both radius phases reach the non-fused K4 branch on the int8 route,
    # and the seg-64 ops phase runs K5/K6 on it; the fp32 K4 and K5/K6
    # kernels launch nowhere on the 8-bit main path
    for name in ("radius_high_batch8", "radius_many_batch128"):
        if counts[name]["surface_i8_launches"] == 0:
            raise AssertionError(f"{name}: K4's int8 route not taken "
                                 f"({counts[name]})")
    if counts["ops_fused_scan_seg64_batch1024"][
            "segmin_free_seg_i8_launches"] == 0:
        raise AssertionError("the seg-64 ops phase did not run K5/K6's int8 "
                             "route")
    if launches["surface"] != launches["surface_i8"] or \
            launches["segmin_free_seg"] != launches["segmin_free_seg_i8"]:
        raise AssertionError(f"the fp32 K4 or K5/K6 kernel ran on the 8-bit "
                             f"main path: {launches}")

    est = capacity.search_transient(coll.columns.capacity)
    report["radius_many_transient"] = {"measured_bytes": transient,
                                       "estimate_bytes": est["peak"]}
    log(f"radius_many batch 128 device transient: {transient} bytes "
        f"(estimate {est['peak']})")
    if transient > est["peak"]:
        raise AssertionError("the radius group's device transient exceeds "
                             "core/capacity.py's estimate")

    truth = oracle_top10(oracle, q64)
    rec = {"high": recall(high[:64], truth), "exact": recall(exact, truth),
           "medium_batch64": recall(med64, truth),
           "medium_batch8": recall(med8, truth),
           "search_single": recall([single], truth[:1])}
    report["recall_at_10"] = rec
    report["percent_searched"] = {
        "high": high[0].percent_searched,
        "medium_batch64": med64[0].percent_searched,
        "medium_batch8": med8[0].percent_searched,
        "search_single": single.percent_searched}
    log(f"recall@10 vs fp64 oracle: {rec}")
    if rec["high"] < 1.0 or rec["exact"] < 1.0:
        raise AssertionError(f"high/exact recall below 1.0: {rec}")
    if min(rec["medium_batch64"], rec["medium_batch8"]) < 0.99:
        raise AssertionError(f"medium recall below 0.99: {rec}")

    check_radius_and_filters(coll, oracle, queries, rad, radius_plan, flt,
                             n_broad, report)
    del oracle

    # the ops phases: the seg-64 scan's proven rows are high's, and K3's
    # uint8 counts are K2's (W = 5: no count reaches 256)
    ids = coll.columns.ids
    want = [[x.id for x in res.results] for res in high]
    r64, m64 = ops["seg64"]
    if [[int(ids[x]) for x in row] for row in r64.cpu().numpy()] != want:
        raise AssertionError("seg-64 proven rows differ from high's results")
    u8, f32 = ops["u8"]
    if not torch.equal(u8.to(torch.float32), f32):
        raise AssertionError("K3's counts differ from K2's on the main state")
    report["ops"] = {"seg64_proven_margin": m64 or scan.default_tie_margin()}

    # the completeness flags at the margin the collection settled on, and
    # up the escalation ladder until every flag is 1 (the loop Collection
    # runs); the proven rows must be the rows high returned
    _, _, ok6 = scan.fused_scan_topk(
        tq, state["codes"], state["norms"], state["valid"], bits=8,
        metric="cosine", k=K, with_ties=True)
    margin = coll._seg_margin_hint
    first_ok = None
    while True:
        d, r, ok = scan.fused_scan_topk(
            tq, state["codes"], state["norms"], state["valid"], bits=8,
            metric="cosine", k=K, tie_margin=margin, with_ties=True)
        frac = float(ok.float().mean())
        first_ok = frac if first_ok is None else first_ok
        if frac == 1.0:
            break
        margin = coll._escalate_margin(margin)
    got = [[int(ids[x]) for x in row] for row in r.cpu().numpy()]
    if got != want:
        raise AssertionError("proven rows differ from high's results")
    report["flags"] = {"default_margin_ok_frac": float(ok6.float().mean()),
                       "hint_margin": coll._seg_margin_hint,
                       "first_rung_ok_frac": first_ok,
                       "proven_margin": margin or scan.default_tie_margin(),
                       "all_ok": True}
    log(f"completeness flags: {report['flags']}")

    # end-to-end times per batch (warm), host clock around each call
    e2e = {}
    for name, fn, nq, reps in (
            ("high_batch1024", lambda: coll.search_many(
                args(queries, "high")), 1024, 5),
            ("exact_batch8", lambda: coll.search_many(
                args(q64[:8], "exact")), 8, 5),
            ("medium_batch64", lambda: coll.search_many(
                args(q64, "medium")), 64, 5),
            ("medium_batch8", lambda: coll.search_many(
                args(q64[:8], "medium")), 8, 10),
            ("search_single", lambda: coll.search(
                tdb.SearchArgs(vector=queries[1], k=K)), 1, 20),
            ("radius_high_batch8", lambda: coll.radius_many(rargs(
                rq["high"], radius_plan["high"][0], "high")), 8, 5),
            ("radius_many_batch128", lambda: coll.radius_many(rargs(
                rq["many"], radius_plan["many"][0], "high")), 128, 5),
            ("radius_exact_batch8", lambda: coll.radius_many(rargs(
                rq["exact"], radius_plan["exact"][0], "exact")), 8, 5),
            ("radius_medium_batch8", lambda: coll.radius_many(rargs(
                rq["medium"], radius_plan["medium"][0], "medium")), 8, 10),
            ("filter_high_batch1024_broad", lambda: coll.search_many(
                args(queries, "high", filter_query=broad)), 1024, 5),
            ("filter_high_batch1024_narrow", lambda: coll.search_many(
                args(queries, "high", filter_query=narrow)), 1024, 5),
            ("filter_medium_batch8_broad", lambda: coll.search_many(
                args(q64[:8], "medium", filter_query=broad)), 8, 10),
            ("filter_radius_high_batch8", lambda: coll.radius_many(rargs(
                rq["filtered"], radius_plan["filtered"][0], "high",
                filter_query=broad)), 8, 5)):
        ms = statistics.median(wall_ms(fn, reps))
        e2e[name] = {"ms_per_batch": ms, "qps": nq / ms * 1000.0}
    report["e2e"] = e2e
    log(f"end to end: {e2e}")
    report["profile"] = profile_batches(coll, [
        ("high_batch1024", lambda: coll.search_many(args(queries, "high"))),
        ("exact_batch8", lambda: coll.search_many(args(q64[:8], "exact"))),
        ("medium_batch8", lambda: coll.search_many(args(q64[:8],
                                                        "medium"))),
        ("radius_many_batch128", lambda: coll.radius_many(rargs(
            rq["many"], radius_plan["many"][0], "high"))),
        ("radius_high_batch8", lambda: coll.radius_many(rargs(
            rq["high"], radius_plan["high"][0], "high"))),
        ("radius_exact_batch8", lambda: coll.radius_many(rargs(
            rq["exact"], radius_plan["exact"][0], "exact")))])
    return coll, tmp, state, tq, launches


def check_radius_and_filters(coll, oracle, queries, rad, radius_plan, flt,
                             n_broad, report) -> None:
    """Radius id sets against the fp64 oracle (high and exact equal, medium
    recall >= 0.99); filtered results inside their filter and equal to the
    oracle's filtered top-10 (medium: recall >= 0.99)."""
    rrec = {}
    for name in ("high", "many", "exact", "medium", "filtered"):
        radii, truth = radius_plan[name]
        res = rad[name]
        if any(r.distance > radius for x, radius in zip(res, radii)
               for r in x.results):
            raise AssertionError(f"radius {name}: a result past its radius")
        rrec[name] = set_recall(res, truth)
        exact_sets = all({r.id for r in x.results} == t
                         for x, t in zip(res, truth))
        report.setdefault("radius_sizes", {})[name] = \
            [len(t) for t in truth]
        if name != "medium" and not exact_sets:
            raise AssertionError(f"radius {name}: id sets differ from the "
                                 f"fp64 oracle's (recall {rrec[name]})")
    report["radius_set_recall"] = rrec
    log(f"radius id-set recall vs fp64 oracle: {rrec}")
    if rrec["medium"] < 0.99:
        raise AssertionError(f"medium radius recall below 0.99: {rrec}")
    half, last = N_ROWS // 2, N_ROWS - 1000
    if any(r.id >= half for x in rad["filtered"] for r in x.results):
        raise AssertionError("filtered radius returned a row outside the "
                             "filter")

    size = coll.columns.size
    ids_np = coll.columns.ids[:size]
    keeps = {"broad": (ids_np < half, lambda i: i < half),
             "narrow": (ids_np >= last, lambda i: i >= last)}
    frec = {}
    for name, res in flt.items():
        kind = name.split("_")[1]
        mask, inside = keeps[kind]
        if not all(inside(r.id) for x in res for r in x.results):
            raise AssertionError(f"filter {name}: a result outside the "
                                 f"filter")
        nq = len(res)
        truth = oracle_top10(oracle, queries[:nq],
                             torch.from_numpy(mask).to(oracle[0].device))
        frec[name] = recall(res, truth)
        if name.startswith("high") and frec[name] < 1.0:
            raise AssertionError(f"filter {name}: top-10 differs from the "
                                 f"fp64 oracle's ({frec[name]})")
    report["filter_recall_at_10"] = frec
    report["filter_passing"] = {"broad": n_broad}
    log(f"filtered recall@10 vs fp64 oracle: {frec}")
    if min(frec.values()) < 0.99:
        raise AssertionError(f"filtered recall below 0.99: {frec}")


def profile_batches(coll, batches) -> dict:
    """Device time by kernel for one warm batch of each kind, from
    torch.profiler (CUPTI), beside the batch's wall time; the busy share is
    the summed kernel time over the wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in batches:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000.0
        kern, host, launched = {}, {}, 0
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                # host ops and CUDA runtime calls, by their own time
                host[e.key[:80]] = host.get(e.key[:80], 0.0) + \
                    e.self_cpu_time_total / 1000.0
                continue
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) / 1000.0
            if t > 0:
                kern[e.key[:80]] = kern.get(e.key[:80], 0.0) + t
                launched += e.count
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        top_host = sorted(host.items(), key=lambda kv: -kv[1])[:5]
        out[name] = {"wall_ms": wall,
                     "device_busy_ms": busy if kern else None,
                     "busy_share": busy / wall if kern else None,
                     "device_ops": launched,
                     "top_kernels_ms": top, "top_host_ms": top_host}
        log(f"profile {name}: wall {wall:.2f} ms, kernels {busy:.2f} ms "
            f"({launched} device ops)")
        for k, t in top:
            log(f"    {t:9.3f} ms  {k}")
        for k, t in top_host:
            log(f"    {t:9.3f} ms  host: {k}")
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel times at the main path's shapes
# ---------------------------------------------------------------------------

def bound(ops: float, nbytes: float, rate: float = BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over `rate` and the bytes over the memory rate."""
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def int_mm_ms(hashes, qcodes) -> float:
    """The library yardstick of K2 and K3: torch._int_mm of the rows' bits
    unpacked beforehand to an (N, 32 W) int8 0/1 matrix with the (32 W, Q)
    +-1 query matrix (Q a multiple of 8).  The same product as the kernels'
    (popc(q) aside) without their unpacking, reading 8x the sketch bytes;
    checked once against the plain counts."""
    from syzgydb_tpu_torch.ops import hamming_scan

    shifts = torch.arange(32, dtype=torch.int32, device=hashes.device)

    def bits(x):
        return ((x[:, :, None] >> shifts) & 1).reshape(x.shape[0], -1)

    rows = bits(hashes).to(torch.int8)
    qb = bits(qcodes)
    qpm = (1 - 2 * qb).to(torch.int8)  # (Q, 32 W), row-major
    got = torch._int_mm(rows, qpm.t()) + qb.sum(1).to(torch.int32)[None, :]
    want = hamming_scan._hamming_counts(qcodes, hashes)
    if not torch.equal(got.t().to(torch.int64), want):
        raise AssertionError("the _int_mm yardstick does not compute the "
                             "Hamming counts")
    del got, want
    ms = cuda_ms(lambda: torch._int_mm(rows, qpm.t()), reps=20)
    del rows
    return ms


def hamming_times(coll, state, tq, dev) -> dict:
    """K2 (bf16, the medium route's form, and f32) at Q = 8 and 1, and K3
    at Q = 64, on the 1M state: bit-exact against the plain versions, then
    timed beside them, the _int_mm yardstick and their bounds (the
    surface's bytes at each form's width: 2, 4 or 1 a value)."""
    from syzgydb_tpu_torch.ops import hamming_scan

    hashes, valid = state["hashes"], state["valid"]
    n, w = hashes.shape
    out = {}
    qcode = torch.from_numpy(coll.index.encode_np(
        tq[:64].cpu().numpy()).view(np.int32)).to(dev)
    for q in (8, 1):
        qc = qcode[:q].contiguous()
        for dt, tag, size in ((torch.bfloat16, "", 2),
                              (torch.float32, "_f32", 4)):
            got = hamming_scan.hamming_scores(qc, hashes, valid, out_dtype=dt)
            if not torch.equal(got, hamming_scan.hamming_scores_plain(
                    qc, hashes, valid, out_dtype=dt)):
                raise AssertionError(f"K2 ({dt}) differs from its plain "
                                     f"version on the main path's state "
                                     f"(Q={q})")
            del got
            out[f"hamming{tag}_q{q}"] = {
                "ms": cuda_ms(lambda: hamming_scan.hamming_scores(
                    qc, hashes, valid, out_dtype=dt), reps=20),
                **bound(2.0 * q * n * 32 * w,
                        4 * n * w + n + 4 * q * w + size * q * n, INT8_OPS)}
    out["hamming_q8"]["plain_ms"] = cuda_ms(
        lambda: hamming_scan.hamming_scores_plain(
            qcode[:8], hashes, valid, out_dtype=torch.bfloat16), reps=5)
    out["hamming_q8"]["library_ms"] = int_mm_ms(hashes, qcode[:8])
    log("K2 at the main path's shapes: bit-exact against its plain version "
        "(bf16 and f32, Q = 8 and 1); ms " + ", ".join(
            f"{k} {out[k]['ms']:.4f} (bound {out[k]['bound_ms']:.4f})"
            for k in ("hamming_q8", "hamming_f32_q8", "hamming_q1",
                      "hamming_f32_q1")) +
        f"; _int_mm Q=8 {out['hamming_q8']['library_ms']:.4f}")

    # K3: uint8 surface at Q = 64, W = 5 (no count reaches 256)
    q = 64
    got = hamming_scan.hamming_scores_u8(qcode, hashes)
    want = hamming_scan.hamming_scores_u8_plain(qcode, hashes)
    out["hamming_u8_max_abs_err"] = u8_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError("K3 differs from its plain version on the main "
                             "path's state (Q=64)")
    del got, want
    out["hamming_u8_q64"] = {
        "ms": cuda_ms(lambda: hamming_scan.hamming_scores_u8(qcode, hashes),
                      reps=20),
        "plain_ms": cuda_ms(lambda: hamming_scan.hamming_scores_u8_plain(
            qcode, hashes), reps=3),
        "library_ms": int_mm_ms(hashes, qcode),
        **bound(2.0 * q * n * 32 * w, 4 * n * w + 4 * q * w + q * n,
                INT8_OPS)}
    log(f"K3 at the main path's shapes: bit-exact against its plain version; "
        f"ms Q=64 {out['hamming_u8_q64']['ms']:.4f} (bound "
        f"{out['hamming_u8_q64']['bound_ms']:.4f}, _int_mm "
        f"{out['hamming_u8_q64']['library_ms']:.4f})")
    return out


def kernel_times(coll, state, tq, dev) -> dict:
    """All six kernels on the ingested state at the main path's query
    counts: each held against its plain version (K1/K4/K5/K6 within the
    flag's bound of an f64 evaluation, K2/K3 bit for bit), then timed."""
    from syzgydb_tpu_torch.ops import scan

    codes, norms, valid = state["codes"], state["norms"], state["valid"]
    n, d = codes.shape
    out = {"segmin_max_abs_err": 0.0, "segmin_max_err_over_bound": 0.0,
           "segmin_max_err_over_ulp_bound": 0.0}
    cb = codes.to(torch.bfloat16)
    for q in (1024, 64, 8):
        qq = tq[:q].contiguous()
        got = scan.segment_min_scan(qq, codes, norms, valid, bits=8,
                                    metric="cosine")
        err, ratio, ulps = i8_checks(got, qq, codes, norms, valid, "cosine",
                                     d, f"main path Q={q}")
        del got
        out["segmin_max_abs_err"] = max(out["segmin_max_abs_err"], err)
        out["segmin_max_err_over_bound"] = max(
            out["segmin_max_err_over_bound"], ratio)
        out["segmin_max_err_over_ulp_bound"] = max(
            out["segmin_max_err_over_ulp_bound"], ulps)
        # the bound as the table defines it (bf16 tensor rate or bytes),
        # and the 3-slice int8 floor beside it
        ops = 2.0 * q * n * d
        qb = qq.to(torch.bfloat16)
        out[f"segmin_q{q}"] = {
            "ms": cuda_ms(lambda: scan.segment_min_scan(
                qq, codes, norms, valid, bits=8, metric="cosine"), reps=5),
            "slice_ms": cuda_ms(lambda: scan.slice_queries(qq), reps=5),
            "plain_ms": cuda_ms(lambda: scan.segment_min_scan_plain(
                qq, codes, norms, valid, bits=8, metric="cosine"), reps=3),
            "library_ms": cuda_ms(lambda: qb @ cb.T, reps=5),
            "int8_floor_ms": scan.I8_SLICES * ops / INT8_OPS * 1e3,
            **bound(ops, n * d + 5 * n + 4 * q * d + 4 * q * (n // 32))}
    # the fp32 kernel (K1 before its int8 route) on the same inputs
    out["segmin_q1024"]["fp32_kernel_ms"] = cuda_ms(
        lambda: scan.segmin_fp32(tq, codes, norms, valid, bits=8,
                                 metric="cosine", seg=32), reps=3)
    log(f"K1 at the main path's shapes: within delta of f64 (max |err| "
        f"{out['segmin_max_abs_err']:.3g}, max err/delta "
        f"{out['segmin_max_err_over_bound']:.3g}) and within 4 ulps on "
        f"q_hat (max err/bound {out['segmin_max_err_over_ulp_bound']:.3g})")
    log("K1 ms (int8 route, slicing included): " + ", ".join(
        f"Q={q} {out[f'segmin_q{q}']['ms']:.4f} (slicing "
        f"{out[f'segmin_q{q}']['slice_ms']:.4f}, int8 floor "
        f"{out[f'segmin_q{q}']['int8_floor_ms']:.4f}, bound "
        f"{out[f'segmin_q{q}']['bound_ms']:.4f})" for q in (1024, 64, 8)) +
        f"; fp32 kernel Q=1024 {out['segmin_q1024']['fp32_kernel_ms']:.3f}")
    del cb

    out.update(hamming_times(coll, state, tq, dev))

    # K4 on the int8 route: the exact f32 surface at Q = 128 (the radius
    # group's chunk) and Q = 8 (radius high's escalation), held both ways
    # with its bf16 form at Q = 128, then timed
    out["surface_max_abs_err"] = out["surface_max_err_over_ulp_bound"] = 0.0
    cb = codes.to(torch.bfloat16)
    for q, forms in ((128, (True, False)), (8, (True,))):
        qq = tq[:q].contiguous()
        for exact in forms:
            got = scan.score_surface(qq, codes, norms, valid, bits=8,
                                     metric="cosine", exact=exact)
            err, _, ulps = i8_checks(got, qq, codes, norms, valid, "cosine",
                                     d, f"main path K4 Q={q} exact={exact}",
                                     seg=None, bf16=not exact)
            del got
            if exact:  # the f32 surface's (see i8_free_and_surface)
                out["surface_max_abs_err"] = max(out["surface_max_abs_err"],
                                                 err)
                out["surface_max_err_over_ulp_bound"] = max(
                    out["surface_max_err_over_ulp_bound"], ulps)
        ops = 2.0 * q * n * d
        qb = qq.to(torch.bfloat16)
        out[f"surface_q{q}"] = {
            "ms": cuda_ms(lambda: scan.score_surface(
                qq, codes, norms, valid, bits=8, metric="cosine",
                exact=True), reps=5),
            "plain_ms": cuda_ms(lambda: scan.score_surface_plain(
                qq, codes, norms, valid, bits=8, metric="cosine",
                exact=True), reps=3),
            "library_ms": cuda_ms(lambda: qb @ cb.T, reps=5),
            "int8_floor_ms": scan.I8_SLICES * ops / INT8_OPS * 1e3,
            **bound(ops, n * d + 5 * n + 4 * q * d + 4 * q * n)}
    # the fp32 kernel (K4 before its int8 route) on the same inputs
    out["surface_q128"]["fp32_kernel_ms"] = cuda_ms(
        lambda: scan.surface_fp32(tq[:128], codes, norms, valid, bits=8,
                                  metric="cosine", exact=True), reps=3)
    log(f"K4 at the main path's shapes: within delta of f64 (max |err| "
        f"{out['surface_max_abs_err']:.3g}) and within 4 ulps on q_hat (max "
        f"err/bound {out['surface_max_err_over_ulp_bound']:.3g}); ms " +
        ", ".join(f"Q={q} {out[f'surface_q{q}']['ms']:.4f} (int8 floor "
                  f"{out[f'surface_q{q}']['int8_floor_ms']:.4f}, bound "
                  f"{out[f'surface_q{q}']['bound_ms']:.4f})"
                  for q in (128, 8)) +
        f"; fp32 kernel Q=128 {out['surface_q128']['fp32_kernel_ms']:.3f}")

    # K5/K6 on the int8 route: segment minima at seg 16, 64, 128, Q = 1024
    q = 1024
    ops = 2.0 * q * n * d
    qb = tq.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: qb @ cb.T, reps=5)
    out["segmin_free_max_abs_err"] = 0.0
    out["segmin_free_max_err_over_ulp_bound"] = 0.0
    for seg in (16, 64, 128):
        got = scan.segment_min_scan(tq, codes, norms, valid, bits=8,
                                    metric="cosine", seg=seg)
        err, _, ulps = i8_checks(got, tq, codes, norms, valid, "cosine", d,
                                 f"main path seg {seg}", seg=seg)
        del got
        out["segmin_free_max_abs_err"] = max(out["segmin_free_max_abs_err"],
                                             err)
        out["segmin_free_max_err_over_ulp_bound"] = max(
            out["segmin_free_max_err_over_ulp_bound"], ulps)
        out[f"segmin_seg{seg}_q1024"] = {
            "ms": cuda_ms(lambda: scan.segment_min_scan(
                tq, codes, norms, valid, bits=8, metric="cosine", seg=seg),
                reps=5),
            "plain_ms": cuda_ms(lambda: scan.segment_min_scan_plain(
                tq, codes, norms, valid, bits=8, metric="cosine", seg=seg),
                reps=3),
            "library_ms": library_ms,
            "int8_floor_ms": scan.I8_SLICES * ops / INT8_OPS * 1e3,
            **bound(ops, n * d + 5 * n + 4 * q * d + 4 * q * (n // seg))}
    # the fp32 kernel (K5/K6 before their int8 route) at seg 64
    out["segmin_seg64_q1024"]["fp32_kernel_ms"] = cuda_ms(
        lambda: scan.segmin_fp32(tq, codes, norms, valid, bits=8,
                                 metric="cosine", seg=64), reps=3)
    del cb
    log(f"K5/K6 at the main path's shapes: within delta of f64 (max |err| "
        f"{out['segmin_free_max_abs_err']:.3g}) and within 4 ulps on q_hat "
        f"(max err/bound {out['segmin_free_max_err_over_ulp_bound']:.3g}); "
        f"ms Q=1024 " + ", ".join(
            f"seg {seg} {out[f'segmin_seg{seg}_q1024']['ms']:.4f}"
            for seg in (16, 64, 128)) +
        f"; fp32 kernel seg 64 "
        f"{out['segmin_seg64_q1024']['fp32_kernel_ms']:.3f}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs an NVIDIA GPU")
        return 2
    t_start = time.perf_counter()
    from syzgydb_tpu_torch import native
    from syzgydb_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    for name, ptxas in cuda_build.build_all().items():
        log(f"--- nvcc {name}.cu ---\n{ptxas}")
    # the JSON field projector (g++) too, so the first filter mask is
    # timed without its build; without g++ filters parse in Python
    report["jsonproj_native"] = native.get_jsonproj() is not None
    report["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {report['build_s']:.1f} s")

    errs = check_kernels(dev)
    coll, tmp, state, tq, launches = main_path(dev, report)
    times = kernel_times(coll, state, tq, dev)
    report["kernel_times"] = times
    coll.close()
    shutil.rmtree(tmp, ignore_errors=True)
    report["total_s"] = time.perf_counter() - t_start
    print(json.dumps(report), flush=True)

    seg, ham = times["segmin_q1024"], times["hamming_q8"]
    ham8, surf = times["hamming_u8_q64"], times["surface_q128"]
    free = times["segmin_seg64_q1024"]

    def row(name, source, replaces, launched, err, t, library):
        return {"name": name, "route": "cuda",
                "source": f"syzgydb_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library}

    free_err = max(errs["free_seg"], times["segmin_free_max_abs_err"])
    kernels = [
        # K1 on the main path (8-bit codes, seg 32) is the int8 route
        row("segmin", "segmin_i8.cu", "syzgydb_tpu/ops/pallas_scan.py:416",
            launches["segmin_i8"],
            max(errs["segmin"], times["segmin_max_abs_err"]), seg,
            seg["library_ms"]),
        # K2's row is its bf16 form at Q = 8, the medium route's launch
        row("hamming", "hamming.cu", "syzgydb_tpu/ops/pallas_hamming.py:42",
            launches["hamming"], errs["hamming"], ham, ham["library_ms"]),
        row("hamming_u8", "hamming.cu",
            "syzgydb_tpu/ops/pallas_hamming.py:27", launches["hamming_u8"],
            max(errs["hamming_u8"], times["hamming_u8_max_abs_err"]), ham8,
            ham8["library_ms"]),
        # K4 and K5/K6 on the main path (8-bit codes) are the int8 route
        row("surface", "segmin_i8.cu", "syzgydb_tpu/ops/pallas_scan.py:272",
            launches["surface"],
            max(errs["surface"], times["surface_max_abs_err"]), surf,
            surf["library_ms"]),
        # K5 and K6 are two TPU layouts of one function: one CUDA kernel
        # (the SegMin epilogue at seg != 32) and one launch count serve both
        # rows, timed at the main path's seg 64
        row("segmin_free_seg_transposed", "segmin_i8.cu",
            "tools_dev/superseded_kernels.py:33",
            launches["segmin_free_seg"], free_err, free, free["library_ms"]),
        row("segmin_free_seg_natural", "segmin_i8.cu",
            "tools_dev/superseded_kernels.py:138",
            launches["segmin_free_seg"], free_err, free, free["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

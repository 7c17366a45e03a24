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
  3a. mesh (syzgydb_tpu_torch/parallel/, Collection.use_mesh): the 1M
     collection on a data-axis mesh of every CUDA device, or of cuda:0
     four times on one card (the shards then run one after another), held
     against itself on one device: high batches 1024, 64 and 8, exact
     batch 8 and a filtered high batch 64 with ids and distances bit for
     bit, every flag proven on the sharded state up the margin ladder; a
     high radius batch 8 past the fused bound (K4 on every shard) with the
     single device's and the fp64 oracle's id sets; medium batch 8 (K2 on
     every shard) at recall@10 >= 0.99.  The launch counters are reset
     before the sharded searches and read after: K1 once per shard per
     fused dispatch, K4 and K2 on every shard.  A bounded mutation batch
     (64 rows rewritten) is scattered per shard (one "scatter" sync, no
     "full"), the sharded answer after it equals the single device's, the
     rows are restored and use_mesh(None) gives back the single-device
     answer.  Then models/embedder.train_step_sharded at full width (f32)
     on a data 2 x feature 2 mesh against train_step on the same batch.
     ms per batch (high 1024/64/8, medium 8) on the mesh and on one device
     go on a {"mesh": {...}} line with the card's name and power limit,
     beside the mesh run's own launch counts (the kernels line keeps the
     main path's).
  3b. serving: the port's REST server (syzgydb_tpu_torch.server.rest) on
     CUDA with the 1M collection registered as "smoke", driven by 32
     keep-alive HTTP clients (one http.client connection per thread):
     (a) k = 10 at high, 512 requests, then each client's 16 four times
     (2048), every top-10 the fp64 oracle's and percent_searched 100, then
     the 2048 under torch.profiler for their kernel time (the host share is
     taken over the wall without the profiler); (b) 512 requests at the
     server's default precision (medium), recall >= 0.99, then one client
     alone (16 requests: lone queries on the sketch index, K2); (c) radius
     at high, 16 clients x 8, radii at ~50 rows (client 0: ~2000 rows, so
     its groups escalate into K4), id sets equal to the oracle's; (d)
     k = 10 at high with the filter i < 500000, filtered top-10 the
     oracle's.  Per
     sub-phase: QPS over the whole window and while every client is in
     flight, p50/p99 on the client clock, queries per batcher dispatch,
     K1/K2/K4 launches, and how many result fetches were enqueued behind a
     later group's dispatch (FetchWatch).  Then a REST flow at the
     server's defaults (quantization 64: K1 on csrc/segmin.cu) on a second
     data folder: create, 8 inserts of 1024 corpus rows, 64 concurrent
     high searches at recall 1.0, a metadata update, a record delete, ids
     and stats, a restart from the folder with the same answers, and the
     collection's delete (rest_flow_steps, which the card test
     tests/test_torch_cuda.py runs too).  Any non-2xx status or client
     exception fails
     the run; every kernel of the serving path must launch in it.
  3c. the server's default width: a 262,144 x 384 cosine collection at
     quantization 64 (f32 codes: the fp32 K1 and K4 of csrc/segmin.cu and
     csrc/surface.cu) from the corpus's first rows, high batches of 16 and
     64 (the batcher's group sizes) and a radius high batch of 16 (half of
     it at ~2000 rows, escalating into K4): recall@10 1.0 and radius id
     sets equal to the fp64 oracle's, every flag 1, fp32 K1 and K4 launched
     and no int8 route, and both held against their plain version in f64
     on the collection's state at Q = 16, 17 and 64, both metrics; wall ms
     per batch beside the kernels' ms.
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
     estimate; and the fp32 kernels at the other widths (bits 4, 16, 32
     and 64, 1,048,576 x 384 seeded synthetic codes): every query tile
     (16, 32, 64, 128) held against its plain version on 262,144 rows at
     Q in {1, 16, 17, 64, 65, 128, 129}, both metrics, two launches
     bit-identical; then K1 at Q = 1024, 64 and 16 and K4 at Q = 128 and
     16 timed beside fp32 (TF32 off) and bf16 torch.matmul, and K1 on
     64-bit codes at Q = 16, 32, 64 on every tile that holds them.
  4b. tools (syzgydb_tpu_torch/tools/), their launch counters reset
     before the phase and read after it: the 1M collection exported
     compact (export_json, base64 of the packed bytes) and imported on
     the card (import_json): high batch 1024 with equal ids, bit-equal
     f32 distances and every flag 1, medium batch 8 (K2) equal, equal
     device sketches and counts, and dump_index of the copy's file finding
     every record with a good CRC; a 32,768 x 384 quantization-64
     collection exported as float text and imported (high batch 16, fp32
     K1, equal likewise); a SyzgyDB Go .dat of the first 131,072 rows
     (build_ref_file) migrated with import_ref_file, each top-10 the
     source's under "i < 131072".  Export, import and migration rows/s and
     MB/s, and the copies' first-batch ms, go on a {"tools": {...}} line
     with the card's name and power limit.
  5. embedder (embedder: device): (1) the full-width MiniLM-L6-shaped
     encoder (vocab 30522, hidden 384, 6 layers, 12 heads, MLP 1536,
     max_len 128) in both archs with seeded random weights, bf16 on the
     card against f32 on the CPU with the same weights, within twice the
     CPU's own bf16-against-f32 error; (2) the shipped checkpoint on the
     card clears the retrieval gate (>= 0.9) and random weights of its
     config do not (< 0.5); (3) the REST text flow of
     tests/test_embedder.py (12 text inserts, 12 held-out text queries,
     >= 11 top-1); (4) 131,072 corpus documents inserted as text through
     the REST server with the full-width preln model (POSTs of 1,024) into
     a 384-d cosine collection at quantization 8, then 32 keep-alive
     clients x 16 high text searches (recall@10 1.0 against the fp64
     oracle for the handlers' own query vectors) and one client x 16
     default-precision (medium, K2) text searches (ids within the sketch
     budget's ties of the exact top-10), K1 (int8) and K2 launched, the
     counters reset before this step and read after; (5) embed ms and
     texts/s at batch 1, 16, 64, 256 and 1,024 (forward alone on CUDA
     events, and the whole embed() call), each beside its bound.
  6. training (models/embedder.py's contrastive_loss, train_step,
     make_optimizer; models/train_synthetic.py), the launch counters reset
     before it and read after (the path runs no kernel of the port): (1)
     training_config() (f32) with the same seeded weights on the card and
     on the CPU, 48 pairs: loss within 1e-4 relative, every gradient
     tensor within 1e-5 of its max |g| (the key third of attn.qkv.bias,
     whose true gradient is 0, <= 1e-6 in both), one SGD step's
     parameters within 1e-6, five AdamW steps' losses within 1e-4
     relative, with the caller's TF32 switch on and every Dense forward
     and backward seen running with it off; (2) the full-width preln
     encoder in bf16 on the card against the CPU's f32 at 16 pairs: loss
     and worst per-tensor gradient cosine within twice the CPU's own
     bf16-against-f32 distance (floored at 1e-3 relative and 0.99); (3)
     `python -m syzgydb_tpu_torch.models.train_synthetic --out <tmp>
     --steps 400` on the card: exit 0 (the 0.9 gate), and the checkpoint
     clears the gate again loaded on the card and on the CPU; (4) step
     times: forward and backward, and AdamW apart (CUDA events), the
     whole step (host clock), pairs/s and peak memory at
     training_config() with 48 pairs and at full width (bf16) with 16, 64
     and 256 pairs, each beside its bound, and torch.profiler over one
     256-pair step (kernel time by name, elementwise share).  It prints
     {"training": {...}} with the card's name and power limit.

The report line (the mesh phase under "mesh", serving numbers under
"serving", the 64-bit phase under "e2e_64bit", the embedder's under
"embedder", training under "training") comes before the
{"kernels": [...]} line (K1-K6, and K1 and K4 on f32 codes with the
64-bit phase's launches and errors; every row's bound_ms is the larger of
the operations over the bf16 tensor rate and the bytes over the memory
rate), and the last line is {"ok": true, "device": {...}}.  The embedder
and its training have no kernel of their own (no Pallas kernel in the JAX
package's models/), so they add no row to the kernels line.
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
FP32_FLOPS = 67e12  # outside the tensor cores
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
                 dq_rel=None, bits=8):
    """Segment minima (K1, K5/K6) against the plain version in f64:
    identical +inf positions and every finite error within the completeness
    flag's own bound (surface_delta, with the int8 route's dq_rel and the
    codes' bits where given).  Returns (max |err|, max err/bound)."""
    from syzgydb_tpu_torch.ops import scan

    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"segment minima: +inf positions differ: "
                             f"{what}")
    delta = scan.surface_delta(qn2, norms, valid, metric=metric, dims=dims,
                               dq_rel=dq_rel, bits=bits
                               ).to(torch.float64)[:, None]
    err = (got.double() - want).abs()
    err = torch.where(torch.isinf(want), torch.zeros_like(err), err)
    ratio = float((err / delta).max())
    if ratio > 1.0:
        raise AssertionError(f"segment minima off the plain version by "
                             f"{ratio:.3g} x delta: {what}")
    return float(err.max()), ratio


def i8_checks(got, tq, codes, norms, valid, metric, dims, what,
              seg=32, bf16=False, bits=8):
    """The int8 route (8-bit codes: K1 at seg 32, K5/K6 at seg 16/64/128,
    K4's surface for seg=None, bf16 or f32; 16-bit codes: K1 and K5/K6)
    held both ways: within
    surface_delta (with slice_queries' dq_rel) of the f64 plain version on
    the unrounded queries, and within 4 f32 ulps of the surrogate's terms
    (i8_term_scale) of the f64 plain version on the sliced queries q_hat
    with the unrounded |q|^2 and sum; identical +inf positions; bf16 plus
    half an ulp of the value each way.  Returns (max |err| vs the unrounded
    queries, max err/delta, max err/ulp bound)."""
    from syzgydb_tpu_torch.ops import scan

    def plain(q, terms=None):
        if seg is None:
            return scan.score_surface_plain(q, codes, norms, valid, bits=bits,
                                            metric=metric,
                                            dtype=torch.float64,
                                            query_terms=terms)
        return scan.segment_min_scan_plain(q, codes, norms, valid, bits=bits,
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
                                  what, dq_rel=dq_rel, bits=bits)
    del want
    qhat = scan.unslice_queries(slices, scale)[:, :dims]
    tight = plain(qhat, (qn2, tq.sum(-1)))
    got = got.double()
    if not torch.equal(torch.isinf(got), torch.isinf(tight)):
        raise AssertionError(f"int8 route: +inf positions differ on q_hat: "
                             f"{what}")
    tol = 4 * 2.0 ** -24 * scan.i8_term_scale(
        qn2, norms, valid, metric=metric, dims=dims,
        bits=bits).double()[:, None]
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
                if bits in (8, 16):  # K1's int8 route
                    err, ratio, ulps = i8_checks(got, tq, tc, tn, tv,
                                                 metric, d, what, bits=bits)
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
            got = scan.segment_min_scan(tq, tc, tn, tv, bits=bits,
                                        metric=metric, seg=seg)
            what = f"seg {seg} {bits}-bit {metric}"
            if bits == 16:  # K5/K6 on the int8 route
                err, ratio, ulps = i8_checks(got, tq, tc, tn, tv, metric, d,
                                             what, seg=seg, bits=bits)
                i8_ulp = max(i8_ulp, ulps)
                i8_runs += 1
            else:
                want = scan.segment_min_scan_plain(
                    tq, tc, tn, tv, bits=bits, metric=metric, seg=seg,
                    dtype=torch.float64)
                err, ratio = segmin_error(got, want, qn2, tn, tv, metric, d,
                                          what)
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
        f"{i8_runs} 8-bit K1, K5/K6 and K4 and 16-bit K1 and K5/K6 ones "
        f"(int8 route) also within 4 ulps on q_hat (max err/bound "
        f"{i8_ulp:.3g}, f32 outputs)")
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


def counters() -> dict:
    """Every kernel wrapper's launch count."""
    from syzgydb_tpu_torch.ops import hamming_scan, scan

    return {"segmin": scan.launches, "segmin_i8": scan.i8_launches,
            "hamming": hamming_scan.launches,
            "hamming_u8": hamming_scan.u8_launches,
            "surface": scan.surface_launches,
            "surface_i8": scan.i8_surface_launches,
            "segmin_free_seg": scan.free_seg_launches,
            "segmin_free_seg_i8": scan.i8_free_seg_launches}


def reset_counters() -> None:
    from syzgydb_tpu_torch.ops import hamming_scan, scan

    scan.launches = scan.free_seg_launches = scan.surface_launches = 0
    scan.i8_launches = scan.i8_free_seg_launches = scan.i8_surface_launches = 0
    scan.i8_hilo_launches = 0
    scan.rerank_rows = scan.pairs_scored = 0
    hamming_scan.launches = hamming_scan.u8_launches = 0


def proven_rows(coll, tq, bits: int):
    """K1's completeness flags on the collection's state, from its margin
    hint up the escalation ladder until every flag is 1 (the loop
    Collection runs) -> (ids per query, the first rung's ok share, the
    margin that proved every query)."""
    from syzgydb_tpu_torch.ops import scan

    state = coll._device_state()
    margin, first = coll._seg_margin_hint, None
    while True:
        _, r, ok = scan.fused_scan_topk(
            tq, state["codes"], state["norms"], state["valid"], bits=bits,
            metric=coll.metric, k=K, tie_margin=margin, with_ties=True)
        frac = float(ok.float().mean())
        first = frac if first is None else first
        if frac == 1.0:
            break
        margin = coll._escalate_margin(margin)
    ids = coll.columns.ids
    return [[int(ids[x]) for x in row] for row in r.cpu().numpy()], first, \
        margin


def ingest_corpus(report: dict):
    """The main path's 1M x 384 cosine 8-bit collection, ingested through
    Collection.add_documents -> (collection, its folder, the queries, the
    first ROWS64 rows)."""
    import syzgydb_tpu_torch as tdb

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
    rows64 = db[:ROWS64].copy()  # the 64-bit phase's and the REST flow's
    del db
    log(f"ingested {N_ROWS} rows in {report['ingest_s']:.1f} s "
        f"(capacity {coll.columns.capacity})")
    return coll, tmp, queries, rows64


def main_path(dev, report: dict):
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.core import capacity
    from syzgydb_tpu_torch.ops import hamming_scan, scan

    coll, tmp, queries, rows64 = ingest_corpus(report)

    # every kernel's count starts at 0 here and is read after the last
    # phase; the oracle between phases launches none of them
    reset_counters()
    counts = {}

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
    report["ops"] = {"seg64_proven_margin": m64 or scan.DEFAULT_TIE_MARGIN}

    # the completeness flags at the margin the collection settled on, and
    # up the escalation ladder until every flag is 1 (the loop Collection
    # runs); the proven rows must be the rows high returned
    _, _, ok6 = scan.fused_scan_topk(
        tq, state["codes"], state["norms"], state["valid"], bits=8,
        metric="cosine", k=K, with_ties=True)
    got, first_ok, margin = proven_rows(coll, tq, 8)
    if got != want:
        raise AssertionError("proven rows differ from high's results")
    report["flags"] = {"default_margin_ok_frac": float(ok6.float().mean()),
                       "hint_margin": coll._seg_margin_hint,
                       "first_rung_ok_frac": first_ok,
                       "proven_margin": margin or scan.DEFAULT_TIE_MARGIN,
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
    return coll, tmp, state, tq, launches, rows64


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
    the summed kernel time over the wall time (profiler on), and the
    elementwise and reduction shares are those kernels' time (names with
    "elementwise" or "reduce_kernel") over the summed kernel time."""
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
        elem = sum(t for k, t in kern.items() if "elementwise" in k)
        red = sum(t for k, t in kern.items() if "reduce_kernel" in k)
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        top_host = sorted(host.items(), key=lambda kv: -kv[1])[:5]
        out[name] = {"wall_ms": wall,
                     "device_busy_ms": busy if kern else None,
                     "busy_share": busy / wall if kern else None,
                     "device_ops": launched,
                     "elementwise_share": elem / busy if kern else None,
                     "reduce_share": red / busy if kern else None,
                     "top_kernels_ms": top, "top_host_ms": top_host}
        log(f"profile {name}: wall {wall:.2f} ms, kernels {busy:.2f} ms "
            f"({launched} device ops; elementwise "
            f"{out[name]['elementwise_share']}, reductions "
            f"{out[name]['reduce_share']})")
        for k, t in top:
            log(f"    {t:9.3f} ms  {k}")
        for k, t in top_host:
            log(f"    {t:9.3f} ms  host: {k}")
    return out


# ---------------------------------------------------------------------------
# phase 3a: the main path on a mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # data shards on a one-card mesh
MESH_MUTATED = 64  # rows rewritten by the bounded mutation batch
# the sharded train step against the unsharded one (full width, f32, one
# SGD step at lr 1e-2): the loss within 1e-5 relative, every parameter
# within SGD_ATOL, and each parameter tensor within the larger of
# MESH_STEP_RTOL of its largest step and MESH_ULPS f32 ulps of its largest
# |p|.  Summation order moved no tensor's step by more than 7.8e-4 of
# its largest (the H100 and the CPU at full width), the worst a LayerNorm
# scale near 1.0 by one ulp of the parameter; a missing replica sum or a
# wrong split moves it by half of it or more.
MESH_TRAIN_PAIRS, MESH_LOSS_RTOL = 16, 1e-5
MESH_STEP_RTOL, MESH_ULPS = 1e-3, 2


ONE_CARD = (f"{MESH_SHARDS} shards on one H100, run one after another: "
            f"not a multi-GPU rate")


def mesh_devices() -> tuple[list, str]:
    """Every CUDA device when there are two or more, else cuda:0 four
    times, and what the times on that mesh are."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)], \
            f"{n} shards on {n} GPUs"
    return [torch.device("cuda", 0)] * MESH_SHARDS, ONE_CARD


class DispatchCount:
    """Counts the sharded dispatches Collection makes (parallel/search's
    entry points, wrapped while the phase runs): fused and non-fused exact
    dispatches, and sketch dispatches."""

    def __init__(self):
        from syzgydb_tpu_torch.parallel import search as psearch

        self.mod = psearch
        self.real = (psearch.sharded_exact_topk, psearch.sharded_ann_topk)
        self.n = {"fused": 0, "surface": 0, "ann": 0}

        def exact(mesh, queries, codes, norms, valid, **kw):
            fused = psearch.fused_ok(kw["k"], norms[0].shape[0])
            self.n["fused" if fused else "surface"] += 1
            return self.real[0](mesh, queries, codes, norms, valid, **kw)

        def ann(*a, **kw):
            self.n["ann"] += 1
            return self.real[1](*a, **kw)

        psearch.sharded_exact_topk, psearch.sharded_ann_topk = exact, ann

    def close(self) -> None:
        self.mod.sharded_exact_topk, self.mod.sharded_ann_topk = self.real


def same_answers(got, want, what: str) -> None:
    """Ids and distances bit for bit."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        a = [(r.id, r.distance.hex()) for r in g.results]
        b = [(r.id, r.distance.hex()) for r in w.results]
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            bad.append(f"query {i} from position {j}: {a[j:j + 3]} against "
                       f"{b[j:j + 3]} (lengths {len(a)}, {len(b)})")
    if bad:
        raise AssertionError(f"{what}: {len(bad)} queries differ from the "
                             f"single device's answer; " + "; ".join(bad[:8]))


def mesh_proven(coll, tq) -> tuple[list, float, int]:
    """The mesh's flags on the collection's sharded state, up the margin
    ladder from the mesh default until every flag is 1 -> (ids per query,
    the first rung's ok share, the proving margin)."""
    from syzgydb_tpu_torch.parallel import search as psearch

    st = coll._device_state()
    margin, first = psearch.DEFAULT_MESH_SEG_MARGIN, None
    while True:
        _, r, ok = psearch.sharded_exact_topk(
            coll._mesh, tq, st["codes"], st["norms"], st["valid"], bits=8,
            metric=coll.metric, k=K, seg_margin=margin, with_ties=True)
        frac = float(ok.float().mean())
        first = frac if first is None else first
        if frac == 1.0:
            break
        margin = coll._escalate_margin(margin)
    ids = coll.columns.ids
    return [[int(ids[x]) for x in row] for row in r.cpu().numpy()], first, \
        margin


def mesh_train_step(devices: list) -> dict:
    """train_step_sharded at full width (f32) on a data 2 x feature 2 mesh
    of the card's devices against the unsharded train_step on the same
    batch and weights: the loss within MESH_LOSS_RTOL, every parameter
    within SGD_ATOL, and each parameter tensor within max(MESH_STEP_RTOL x
    its largest step, MESH_ULPS ulps of its largest |p|) after the step."""
    from syzgydb_tpu_torch.models import embedder as te
    from syzgydb_tpu_torch.parallel import mesh as mesh_mod

    cfg = te.EmbedderConfig(dtype="float32")
    emb = te.TextEmbedder(cfg, seed=0, device=devices[0])
    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(data=2, feature=2),
                              [devices[i % len(devices)] for i in range(4)])
    batch = train_batch(emb.tokenizer, 81, MESH_TRAIN_PAIRS)
    before = {n: p.detach().to("cpu", copy=True) for n, p in
              emb.train_model().named_parameters()}
    sharded = te.ShardedEncoder(mesh, emb.train_model())
    t0 = time.perf_counter()
    sloss = float(te.train_step_sharded(mesh, sharded, *batch, lr=1e-2))
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1000.0
    plain = emb.train_model()
    t0 = time.perf_counter()
    ploss = float(te.train_step(plain, *batch, lr=1e-2))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    got = sharded.state_dict()
    max_abs, worst, off = 0.0, (0.0, ""), []
    for name, p in plain.named_parameters():
        p = p.detach().cpu()
        diff = float((got[name] - p).abs().max())
        max_abs = max(max_abs, diff)
        step = float((p - before[name]).abs().max())
        ulp = float(np.spacing(np.float32(p.abs().max())))
        bound = max(MESH_STEP_RTOL * step, MESH_ULPS * ulp)
        worst = max(worst, (diff / bound, name))
        if diff > bound:
            off.append((name, diff, bound))
    loss_rel = abs(sloss - ploss) / abs(ploss)
    out = {"mesh": "data 2 x feature 2", "devices": [str(d) for d in
                                                     mesh.devices.ravel()],
           "pairs": MESH_TRAIN_PAIRS, "loss": sloss, "plain_loss": ploss,
           "loss_rel_err": loss_rel, "max_abs_param_err": max_abs,
           "max_err_over_bound": worst[0], "worst_tensor": worst[1],
           "first_step_ms": sharded_ms, "plain_first_step_ms": plain_ms}
    log(f"mesh train step: {out}")
    if loss_rel > MESH_LOSS_RTOL or max_abs > SGD_ATOL or off:
        raise AssertionError(f"sharded train step off the unsharded one: "
                             f"{off[:8]}; {out}")
    return out


def mesh_phase(coll, tq, rows64: np.ndarray, dev, card: str,
               report: dict) -> None:
    """Phase 3a: the 1M collection on a mesh of every CUDA device, or of
    cuda:0 four times, against itself on one device."""
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    devices, how = mesh_devices()
    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(data=len(devices)),
                              devices)
    shards = mesh.shape["data"]
    log(f"mesh phase: {how}")
    hint = (coll._seg_margin_hint, coll._hint_fail_streak)
    queries = tq.cpu().numpy()
    half = N_ROWS // 2
    flt = f"i < {half}"

    def args(qs, precision, **kw):
        return [tdb.SearchArgs(vector=q, k=K, precision=precision, **kw)
                for q in qs]

    oracle = oracle_vectors(coll, dev)
    rq = queries[128:136]
    radii, rad_truth = oracle_radius(oracle, rq, 2000)
    truth8 = oracle_top10(oracle, queries[:8])
    del oracle

    # the radius group runs first, from no margin hint: its first
    # dispatch (k = 1024) then selects from K4's surface on every shard at
    # the mesh's default margin, where a hint widened by an escalation
    # could select every row and skip K4
    runs = {
        "radius_high_batch8": lambda: coll.radius_many([
            tdb.SearchArgs(vector=q, radius=r, precision="high")
            for q, r in zip(rq, radii)]),
        "high_batch1024": lambda: coll.search_many(args(queries, "high")),
        "high_batch64": lambda: coll.search_many(args(queries[:64], "high")),
        "high_batch8": lambda: coll.search_many(args(queries[:8], "high")),
        "exact_batch8": lambda: coll.search_many(args(queries[:8], "exact")),
        "filter_high_batch64": lambda: coll.search_many(
            args(queries[:64], "high", filter_query=flt)),
        "medium_batch8": lambda: coll.search_many(
            args(queries[:8], "medium"))}
    timed = {"high_batch1024": 5, "high_batch64": 10, "high_batch8": 10,
             "medium_batch8": 10}

    def times() -> dict:
        return {name: statistics.median(wall_ms(runs[name], reps))
                for name, reps in timed.items()}

    single = {name: fn() for name, fn in runs.items()}
    single_ms = times()

    coll.use_mesh(mesh)
    coll._seg_margin_hint, coll._hint_fail_streak = None, 0
    count = DispatchCount()
    try:
        reset_counters()
        t0 = time.perf_counter()
        got, per_run = {}, {}
        for name, fn in runs.items():
            before = dict(count.n)
            got[name] = fn()
            per_run[name] = {k: count.n[k] - before[k] for k in before}
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = counters()
        dispatches = dict(count.n)
    finally:
        count.close()
    log(f"mesh launches {launches}, dispatches {dispatches} ({per_run})")
    # K1 once per shard per fused dispatch, K4 on every shard of the
    # radius group's non-fused dispatches, K2 once per shard per sketch
    # dispatch
    if dispatches["fused"] == 0 or \
            launches["segmin"] != shards * dispatches["fused"] or \
            launches["segmin_i8"] != launches["segmin"]:
        raise AssertionError(f"K1 did not launch once per shard per "
                             f"dispatch: {launches}, {dispatches}")
    if dispatches["surface"] == 0 or launches["surface_i8"] < \
            shards * dispatches["surface"] or launches["surface_i8"] % shards:
        raise AssertionError(f"K4 did not launch on every shard: "
                             f"{launches}, {dispatches}")
    if dispatches["ann"] == 0 or \
            launches["hamming"] != shards * dispatches["ann"]:
        raise AssertionError(f"K2 did not launch once per shard per "
                             f"dispatch: {launches}, {dispatches}")

    errors = []
    for name in ("high_batch1024", "high_batch64", "high_batch8",
                 "exact_batch8", "filter_high_batch64"):
        try:
            same_answers(got[name], single[name], f"mesh {name}")
        except AssertionError as exc:
            errors.append(str(exc))
    if errors:
        raise AssertionError(" | ".join(errors))
    if any(r.id >= half for x in got["filter_high_batch64"]
           for r in x.results):
        raise AssertionError("mesh filtered search left its filter")
    rad_got = [{r.id for r in x.results} for x in got["radius_high_batch8"]]
    if rad_got != [{r.id for r in x.results}
                   for x in single["radius_high_batch8"]] or \
            rad_got != rad_truth:
        raise AssertionError("mesh radius id sets differ from the single "
                             "device's or the fp64 oracle's")
    med_recall = recall(got["medium_batch8"], truth8)
    if med_recall < 0.99:
        raise AssertionError(f"mesh medium recall {med_recall} < 0.99")
    flags = {}
    for name, q in (("high_batch1024", tq), ("high_batch64", tq[:64]),
                    ("high_batch8", tq[:8])):
        ids, first, margin = mesh_proven(coll, q)
        if ids != [[r.id for r in x.results] for x in got[name]]:
            raise AssertionError(f"mesh {name}: proven rows differ from "
                                 f"its results")
        flags[name] = {"first_rung_ok_frac": first, "proven_margin": margin}
    mesh_ms = times()

    # a bounded mutation batch, scattered per shard: MESH_MUTATED rows
    # rewritten near queries 0..63, then the same rows under one device
    ids = np.arange(1000, 1000 + MESH_MUTATED)
    metas = [b'{"i":%d}' % i for i in ids]
    moved = queries[:MESH_MUTATED].astype(np.float64) + 1e-3
    before = dict(coll.sync_stats)
    coll.add_documents(ids.tolist(), moved, metas)
    mutated = runs["high_batch64"]()
    if coll.sync_stats["scatter"] != before["scatter"] + 1 or \
            coll.sync_stats["full"] != before["full"]:
        raise AssertionError(f"the mutation was not scattered per shard: "
                             f"{before} -> {coll.sync_stats}")
    planted = float(np.mean([x.results[0].id == 1000 + i
                             for i, x in enumerate(mutated)]))
    if planted < 0.9:
        raise AssertionError(f"the rewritten rows came first for only "
                             f"{planted} of their queries")
    coll.use_mesh(None)
    same_answers(mutated, runs["high_batch64"](), "mesh after mutation")
    # restore: the same rows with the same vectors, then a fresh placement
    # (device-encoded sketches, as the main path placed them)
    coll.add_documents(ids.tolist(), rows64[ids], metas)
    coll.use_mesh(None)
    same_answers(runs["high_batch64"](), single["high_batch64"],
                 "single device after use_mesh(None)")
    coll._seg_margin_hint, coll._hint_fail_streak = hint

    train = mesh_train_step(devices)
    out = {"card": card, "mesh": [str(d) for d in devices], "shards": shards,
           "how": how, "launches": launches, "dispatches": dispatches,
           "dispatches_per_run": per_run, "first_run_s": first_s,
           "flags": flags,
           "medium_recall_at_10": med_recall,
           "mutation": {"rows": MESH_MUTATED, "planted_top1_frac": planted,
                        "sync_stats": dict(coll.sync_stats)},
           "ms_per_batch": {"mesh": mesh_ms, "one_device": single_ms,
                            "note": how},
           "train_step": train,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"mesh": out}), flush=True)
    report["mesh"] = out


# ---------------------------------------------------------------------------
# phase 3b: serving over HTTP
# ---------------------------------------------------------------------------

N_CLIENTS = 32
FLOW_ROWS, FLOW_BATCH = 8192, 1024


def http_clients(port: int, bodies: list, path: str) -> tuple:
    """One keep-alive http.client connection per client thread, each
    POSTing its JSON bodies in turn, all released together.  -> (parsed
    responses per client, latencies in ms on the client clock, wall s,
    steady QPS).  The steady QPS counts the answers between the moment
    every client has its first one and the moment the first client is
    done, when all of them are in flight: the closed loop's start and
    drain are left out.  Any non-2xx status, or any exception in a
    client, fails the run."""
    import http.client
    import threading

    n = len(bodies)
    out, lat, errors = [None] * n, [[] for _ in range(n)], []
    ends = [[] for _ in range(n)]
    gate = threading.Barrier(n + 1, timeout=60)

    def client(c):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            gate.wait()
            res = []
            for body in bodies[c]:
                t0 = time.perf_counter()
                conn.request("POST", path, body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                ends[c].append(time.perf_counter())
                lat[c].append((ends[c][-1] - t0) * 1000.0)
                if resp.status // 100 != 2:
                    raise AssertionError(f"HTTP {resp.status} from {path}: "
                                         f"{data[:300]!r}")
                res.append(json.loads(data))
            conn.close()
            out[c] = res
        except BaseException as exc:  # re-raised by the caller below
            errors.append(exc)
            gate.abort()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    lo, hi = max(e[0] for e in ends), min(e[-1] for e in ends)
    steady = sum(lo < t <= hi for e in ends for t in e) / (hi - lo) \
        if hi > lo else None
    return out, [x for c in lat for x in c], wall, steady


def http_call(port: int, method: str, path: str, body=None, want=None):
    """One request on its own connection -> parsed JSON; a status other than
    `want` (or any non-2xx when want is None) fails the run."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, body=None if body is None else
                 json.dumps(body), headers={"Content-Type":
                                            "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if (resp.status != want) if want else resp.status // 100 != 2:
        raise AssertionError(f"HTTP {resp.status} from {method} {path}: "
                             f"{data[:300]!r}")
    return json.loads(data)


def start_http(srv):
    import threading

    from syzgydb_tpu_torch.server import rest

    httpd = rest.make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


class FetchWatch:
    """Times every result fetch of a collection and counts, for each, the
    dispatches of other groups enqueued after its own group's dispatch:
    before the fetch started (its copies then wait on the one CUDA stream
    for those later groups' kernels as well), and while it ran (a fetch is
    three copies, so a dispatch between them may delay the later ones)."""

    def __init__(self, coll):
        import threading

        self.coll, self.rows = coll, []
        self.lock, self.seq, self.taken = threading.Lock(), 0, 0
        self.local = threading.local()

        def dispatch(fn):
            def wrapped(*a, **kw):
                with self.lock:
                    self.seq += 1
                    self.local.mark = self.seq
                return fn(*a, **kw)
            return wrapped

        fetch = coll._fetch_results

        def timed_fetch(*a, **kw):
            with self.lock:
                seq0 = self.seq
                later = seq0 - getattr(self.local, "mark", seq0)
            t0 = time.perf_counter()
            out = fetch(*a, **kw)
            ms = (time.perf_counter() - t0) * 1000.0
            with self.lock:
                self.rows.append((later, self.seq - seq0, ms))
            return out

        coll._knn_many_async = dispatch(coll._knn_many_async)
        coll._radius_many_async = dispatch(coll._radius_many_async)
        coll._fetch_results = timed_fetch

    def take(self) -> dict:
        with self.lock:
            rows, self.rows = self.rows, []
            dispatches, self.taken = self.seq - self.taken, self.seq
        behind = [ms for later, during, ms in rows if later or during]
        alone = [ms for later, during, ms in rows if not (later or during)]
        return {"dispatches": dispatches, "fetches": len(rows),
                "after_a_later_dispatch": sum(r[0] > 0 for r in rows),
                "a_later_dispatch_during": sum(r[1] > 0 for r in rows),
                "mean_ms_behind_later": float(np.mean(behind))
                if behind else None,
                "mean_ms_alone": float(np.mean(alone)) if alone else None}

    def remove(self) -> None:
        for name in ("_knn_many_async", "_radius_many_async",
                     "_fetch_results"):
            delattr(self.coll, name)


def serve_phase(name, srv, port, bodies, watch, out: dict) -> list:
    """Drive one sub-phase; record QPS, p50/p99, queries per dispatch, the
    kernels' launches and the fetches.  -> every response, in client
    order.  A sub-phase whose dispatches FetchWatch did not see (its hooks
    no longer on the path) fails."""
    c0, b0 = counters(), (srv.batcher.queries, srv.batcher.dispatches)
    res, lat, wall, steady = http_clients(port, bodies,
                                          "/api/v1/collections/smoke/search")
    torch.cuda.synchronize()
    c1 = counters()
    queries = srv.batcher.queries - b0[0]
    dispatches = srv.batcher.dispatches - b0[1]
    fetch = watch.take()
    if dispatches and not (fetch["dispatches"] and fetch["fetches"]):
        raise AssertionError(f"serving {name}: FetchWatch saw {fetch} behind "
                             f"{dispatches} batcher dispatches")
    out[name] = {
        "requests": len(lat), "clients": len(bodies), "wall_s": wall,
        "qps": len(lat) / wall, "steady_qps": steady,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "batched_queries": queries, "dispatches": dispatches,
        "queries_per_dispatch": queries / dispatches if dispatches else None,
        "launches": {k: c1[k] - c0[k] for k in ("segmin_i8", "hamming",
                                                "surface_i8")},
        "fetch": fetch}
    log(f"serving {name}: {out[name]}")
    return [r for client in res for r in client]


def serve_recall(res, truth) -> float:
    return float(np.mean([len({r["id"] for r in x["results"]} & t) / K
                          for x, t in zip(res, truth)]))


def check_serving_launches(c: dict) -> None:
    """The serving path's kernels: K1 on both routes (the int8 one for the
    8-bit collection, segmin.cu for the 64-bit REST flow), K2 and K4."""
    fp32 = c["segmin"] - c["segmin_i8"]
    if min(c["segmin_i8"], fp32, c["hamming"], c["surface_i8"]) == 0:
        raise AssertionError(f"a kernel of the serving path was not launched "
                             f"in its run: {c}")


def serving(coll, tmp, queries, flow_rows, dev, report: dict) -> None:
    """Phase 3b: the 1M collection behind the port's REST server, driven by
    32 keep-alive HTTP clients, then a REST flow at the server's defaults
    on a second data folder (see rest_flow)."""
    from syzgydb_tpu_torch.server import rest

    oracle = oracle_vectors(coll, dev)
    srv = rest.Server(data_folder=tmp, device=dev)
    srv.collections["smoke"] = coll  # the open collection: no second replay
    httpd, port = start_http(srv)
    watch = FetchWatch(coll)
    out = {"batcher": {"window_s": srv.batcher.window_s,
                       "max_batch": srv.batcher.max_batch}}
    reset_counters()

    def knn(qi, **kw):
        return {"vector": queries[qi].tolist(), "k": K, **kw}

    q512 = [[c * 16 + r for r in range(16)] for c in range(N_CLIENTS)]
    order = [qi for c in q512 for qi in c]
    truth = oracle_top10(oracle, queries[:512])
    try:
        # (a) high: the exact top-10 of every request; the first pass warms
        # the request threads (each makes its first CUDA and cuBLAS calls),
        # the second sends each client's 16 queries 4 times, so that the
        # closed loop's start and drain are a small part of its window
        bodies_a = [[knn(qi, precision="high") for qi in c] for c in q512]
        for name, rounds in (("a_high_first_pass", 1), ("a_high", 4)):
            res = serve_phase(name, srv, port, [b * rounds for b in bodies_a],
                              watch, out)
            out[name]["recall_at_10"] = rec = serve_recall(
                res, [truth[qi] for c in q512 for qi in c * rounds])
            pct = {x["percent_searched"] for x in res}
            if rec < 1.0 or pct != {100.0}:
                raise AssertionError(f"serving {name}: recall {rec}, "
                                     f"percent_searched {pct}")
        # the same traffic under torch.profiler for its kernel time; the
        # host share is taken over the wall of the run without the profiler,
        # which lengthens the wall (its overhead is reported beside it)
        prof = profile_batches(coll, [("serving_high", lambda: http_clients(
            port, [b * 4 for b in bodies_a],
            "/api/v1/collections/smoke/search"))])
        out["a_high"]["profile"] = prof = prof["serving_high"]
        if prof["device_busy_ms"] is not None:
            a = out["a_high"]
            a["host_share"] = 1.0 - prof["device_busy_ms"] / (
                1000.0 * a["wall_s"])
            a["host_share_profiler_on"] = 1.0 - prof["busy_share"]
            a["profiler_wall_over_wall"] = prof["wall_ms"] / (
                1000.0 * a["wall_s"])
        watch.take()

        # (b) the server's default precision (medium), 32 clients, then one
        # client alone: lone queries take the sketch index (K2)
        res = serve_phase("b_default", srv, port,
                          [[knn(qi) for qi in c] for c in q512], watch, out)
        out["b_default"]["recall_at_10"] = serve_recall(
            res, [truth[i] for i in order])
        res = serve_phase("b_default_one_client", srv, port,
                          [[knn(512 + r) for r in range(16)]], watch, out)
        out["b_default_one_client"]["recall_at_10"] = serve_recall(
            res, oracle_top10(oracle, queries[512:528]))
        for name in ("b_default", "b_default_one_client"):
            if out[name]["recall_at_10"] < 0.99:
                raise AssertionError(f"serving {name}: recall below 0.99 "
                                     f"({out[name]['recall_at_10']})")

        # (c) radius at high: 16 clients x 8; client 0's radii hold ~2000
        # rows (its groups escalate past the fused bound into K4), the
        # others' ~50
        rq = queries[528:656]
        wide, narrow = oracle_radius(oracle, rq[:8], 2000), \
            oracle_radius(oracle, rq[8:], 50)
        radii, sets = wide[0] + narrow[0], wide[1] + narrow[1]
        bodies_c = [[{"vector": rq[c * 8 + r].tolist(),
                      "radius": radii[c * 8 + r], "precision": "high"}
                     for r in range(8)] for c in range(16)]
        res = serve_phase("c_radius_high", srv, port, bodies_c, watch, out)
        got = [{r["id"] for r in x["results"]} for x in res]
        out["c_radius_high"]["set_recall"] = float(np.mean(
            [len(g & t) / len(t) for g, t in zip(got, sets)]))
        out["c_radius_high"]["sizes"] = [min(map(len, sets)),
                                         max(map(len, sets))]
        if got != sets:
            raise AssertionError("serving radius: id sets differ from the "
                                 "fp64 oracle's")

        # (d) high with a filter: the filtered top-10
        half = N_ROWS // 2
        keep = torch.from_numpy(coll.columns.ids[:coll.columns.size]
                                < half).to(dev)
        ftruth = oracle_top10(oracle, queries[:512], keep)
        res = serve_phase("d_filtered_high", srv, port,
                          [[knn(qi, precision="high",
                                filter=f"i < {half}") for qi in c]
                           for c in q512], watch, out)
        out["d_filtered_high"]["recall_at_10"] = rec = serve_recall(
            res, [ftruth[i] for i in order])
        if rec < 1.0 or any(r["id"] >= half for x in res
                            for r in x["results"]):
            raise AssertionError(f"serving filtered high: recall {rec}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        watch.remove()
    del oracle
    out["flow"] = rest_flow(flow_rows, queries[:64], dev)
    out["launches"] = launches = counters()
    check_serving_launches(launches)
    report["serving"] = out


def flow_oracle(rows: np.ndarray, queries: np.ndarray, dev,
                drop=()) -> list:
    """fp64 cosine top-10 ids (= row numbers) of the flow's rows."""
    v = torch.from_numpy(rows).to(dev, torch.float64)
    v = v / v.norm(dim=1, keepdim=True)
    q = torch.from_numpy(queries).to(dev, torch.float64)
    q = q / q.norm(dim=1, keepdim=True)
    d = torch.acos((q @ v.T).clamp_(-1.0, 1.0))
    d[:, list(drop)] = np.inf
    return [set(r) for r in torch.topk(d, K, largest=False).indices.cpu()
            .tolist()]


def json_keys(x):
    """The key structure of a JSON value: dicts by their keys in order,
    lists by their first element, scalars by their type."""
    if isinstance(x, dict):
        return [(k, json_keys(v)) for k, v in x.items()]
    if isinstance(x, list):
        return [json_keys(v) for v in x[:1]]
    return type(x).__name__


def rest_flow_steps(folder: str, rows: np.ndarray, dev, search,
                    insert_batch: int) -> list:
    """The REST flow at the server's defaults (no quantization: 64-bit
    codes, K1 on csrc/segmin.cu) through the port's server on `dev`, in the
    empty data folder `folder`: create, inserts of `insert_batch` rows with
    metadata {"i": n}, search("first", srv, port), a metadata update, a
    record delete, ids and stats, search("edited", srv, port), a restart
    from the folder, search("reopened", srv, port), the edited record found
    again, and the collection's delete.  `search` sends its own searches
    (the serving phase's and the card test's differ) to the server `srv`
    listening on `port` and returns their responses.  Any
    unexpected status or answer fails.  -> the JSON key structure of every
    response, in order."""
    from syzgydb_tpu_torch.server import rest

    base, n = "/api/v1/collections", len(rows)
    shapes = []

    def call(port, method, path, body=None, want=None):
        res = http_call(port, method, path, body, want)
        shapes.append(json_keys(res))
        return res

    def serve():
        srv = rest.make_server(folder, device=dev)
        return (srv, *start_http(srv))

    def stop(srv, httpd):
        httpd.shutdown()
        httpd.server_close()
        for c in srv.collections.values():
            c.close()

    srv, httpd, port = serve()
    try:
        call(port, "POST", base, {"name": "flow", "vector_size":
                                  rows.shape[1], "distance_function":
                                  "cosine"}, 201)
        for a in range(0, n, insert_batch):
            call(port, "POST", f"{base}/flow/records", [
                {"id": i, "vector": rows[i].tolist(), "metadata": {"i": i}}
                for i in range(a, min(a + insert_batch, n))], 201)
        shapes += map(json_keys, search("first", srv, port))
        call(port, "PUT", f"{base}/flow/records/5/metadata",
             {"metadata": {"i": 5, "edited": True}}, 200)
        call(port, "DELETE", f"{base}/flow/records/7", want=200)
        ids = call(port, "GET", f"{base}/flow/ids")
        info = call(port, "GET", f"{base}/flow")
        if ids != [i for i in range(n) if i != 7] or \
                (info["document_count"], info["quantization"]) != (n - 1, 64):
            raise AssertionError(f"flow: ids or stats wrong after the edits "
                                 f"({len(ids)} ids, {info})")
        shapes += map(json_keys, search("edited", srv, port))
    finally:
        stop(srv, httpd)
    srv, httpd, port = serve()
    try:
        if srv.collections["flow"].device.type != torch.device(dev).type:
            raise AssertionError("flow: the reopened collection left the "
                                 "server's device")
        shapes += map(json_keys, search("reopened", srv, port))
        info = call(port, "GET", f"{base}/flow")
        five = call(port, "POST", f"{base}/flow/search", {
            "vector": rows[5].tolist(), "k": 1, "precision": "high"})
        if info["document_count"] != n - 1 or \
                [(r["id"], r["metadata"]) for r in five["results"]] != \
                [(5, {"i": 5, "edited": True})]:
            raise AssertionError(f"flow: the reopened server answers "
                                 f"differently ({info}, {five})")
        call(port, "DELETE", f"{base}/flow", want=200)
        if os.path.exists(os.path.join(folder, "flow.dat")):
            raise AssertionError("flow: DELETE left the collection file")
    finally:
        stop(srv, httpd)
    return shapes


def rest_flow(rows: np.ndarray, queries: np.ndarray, dev) -> dict:
    """rest_flow_steps on the corpus's first 8192 rows, in 8 inserts of
    1024, each search step 64 concurrent high searches that must run the
    fp32 K1 (csrc/segmin.cu) and no int8 launch, at recall 1.0 against the
    fp64 oracle; the reopened server returns the edited one's ids and
    distances."""
    from syzgydb_tpu_torch.ops import scan

    path = "/api/v1/collections/flow/search"
    bodies = [[{"vector": q.tolist(), "k": K, "precision": "high"}]
              for q in queries]
    out, got = {}, {}

    def search(tag, srv, port):
        if tag == "first":
            out["create_insert_s"] = time.perf_counter() - t0
        c0 = counters()
        res, lat, wall, _ = http_clients(port, bodies, path)
        torch.cuda.synchronize()
        c1 = counters()
        got[tag] = res = [x[0] for x in res]
        out[tag] = {"wall_s": wall, "p50_ms": float(np.percentile(lat, 50)),
                    "fp32_launches": (c1["segmin"] - c1["segmin_i8"]) -
                    (c0["segmin"] - c0["segmin_i8"]),
                    "i8_launches": c1["segmin_i8"] - c0["segmin_i8"]}
        if out[tag]["fp32_launches"] == 0 or out[tag]["i8_launches"]:
            raise AssertionError(f"flow {tag}: K1 did not run segmin.cu "
                                 f"alone ({out[tag]})")
        return res

    folder = tempfile.mkdtemp(prefix="syzgy_flow_")
    try:
        t0 = time.perf_counter()
        rest_flow_steps(folder, rows, dev, search, FLOW_BATCH)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    truth = flow_oracle(rows, queries, dev)
    edited = flow_oracle(rows, queries, dev, drop=(7,))
    for tag, t in (("first", truth), ("edited", edited),
                   ("reopened", edited)):
        out[tag]["recall_at_10"] = serve_recall(got[tag], t)
    # distance changes in surrogate units, (1 - cos) / 2
    diff = max(abs(np.cos(np.pi * a["distance"]) -
                   np.cos(np.pi * b["distance"])) / 2.0
               for x, y in zip(got["edited"], got["reopened"])
               for a, b in zip(x["results"], y["results"]))
    out["reopened"]["max_surrogate_change"] = float(diff)
    log(f"serving flow (quantization 64): {out}")
    if [[r["id"] for r in x["results"]] for x in got["reopened"]] != \
            [[r["id"] for r in x["results"]] for x in got["edited"]] or \
            diff > 2 * scan.surface_accum_eps(DIMS):
        raise AssertionError(f"flow: the reopened server answers differently "
                             f"({diff})")
    recs = [out[t]["recall_at_10"] for t in ("first", "edited", "reopened")]
    if min(recs) < 1.0:
        raise AssertionError(f"flow: recall below 1.0 ({recs})")
    return out


# ---------------------------------------------------------------------------
# phase 3c: the REST server's default width (quantization 64) end to end
# ---------------------------------------------------------------------------

ROWS64 = 1 << 18


def e2e_64bit(rows: np.ndarray, queries: np.ndarray, dev,
              report: dict) -> dict:
    """A 262,144 x 384 cosine collection at quantization 64 (f32 codes on
    the card: K1 and K4 on csrc/segmin.cu and csrc/surface.cu) from the
    corpus's first rows, queried at the batcher's group sizes through
    search_many (high, batches of 16 and 64) and radius_many (high, a batch
    of 16: 8 radii at ~2000 rows, whose group escalates past the fused
    bound into K4, and 8 at ~50).  Gates: recall@10 1.0 against the fp64
    oracle, radius id sets equal to the oracle's, every completeness flag
    1 up the escalation ladder with the proven rows high's, fp32 K1 and K4
    launched in the run (counters reset before it), and both kernels
    within their bound of the f64 plain version on the collection's state
    at Q = 16, 17 and 64, both metrics.  Reports the wall ms
    per batch beside the fp32 kernels' ms on the collection's state.  The
    collection is closed and its file removed."""
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.ops import scan

    tmp = tempfile.mkdtemp(prefix="syzgy_e2e64_")
    out = {"rows": len(rows)}
    try:
        coll = tdb.Collection(tdb.CollectionOptions(
            name=os.path.join(tmp, "e2e64.dat"), distance_method=tdb.COSINE,
            dimension_count=DIMS, quantization=64, index_seed=4242))
        t0 = time.perf_counter()
        step = 1 << 16
        for a in range(0, len(rows), step):
            ids = list(range(a, min(a + step, len(rows))))
            coll.add_documents(ids, rows[a:a + step],
                               [b'{"i":%d}' % i for i in ids])
        out["ingest_s"] = time.perf_counter() - t0
        v = torch.from_numpy(rows).to(dev, torch.float64)
        oracle = (v / v.norm(dim=1, keepdim=True),
                  torch.ones(len(rows), dtype=torch.bool, device=dev),
                  torch.arange(len(rows), device=dev))
        truth = oracle_top10(oracle, queries[:64])
        rq = queries[64:80]
        wide, narrow = oracle_radius(oracle, rq[:8], 2000), \
            oracle_radius(oracle, rq[8:], 50)
        radii, sets = wide[0] + narrow[0], wide[1] + narrow[1]
        del v, oracle

        def knn(qs):
            return coll.search_many([tdb.SearchArgs(
                vector=q, k=K, precision="high") for q in qs])

        def radius():
            return coll.radius_many([tdb.SearchArgs(
                vector=q, radius=r, precision="high")
                for q, r in zip(rq, radii)])

        reset_counters()
        c0 = counters()
        res16, res64, rad = knn(queries[:16]), knn(queries[:64]), radius()
        torch.cuda.synchronize()
        c1 = counters()
        out["launches"] = {
            "segmin_fp32": (c1["segmin"] - c1["segmin_i8"]) -
            (c0["segmin"] - c0["segmin_i8"]),
            "surface_fp32": (c1["surface"] - c1["surface_i8"]) -
            (c0["surface"] - c0["surface_i8"]),
            "int8": sum(c1[k] - c0[k] for k in
                        ("segmin_i8", "surface_i8", "segmin_free_seg_i8"))}
        out["recall_at_10"] = {"high_batch16": recall(res16, truth[:16]),
                               "high_batch64": recall(res64, truth)}
        got = [{r.id for r in x.results} for x in rad]
        out["radius_sizes"] = [min(map(len, sets)), max(map(len, sets))]
        out["radius_set_recall"] = float(np.mean(
            [len(g & t) / len(t) for g, t in zip(got, sets)]))
        if min(out["recall_at_10"].values()) < 1.0:
            raise AssertionError(f"64-bit phase: recall below 1.0 "
                                 f"({out['recall_at_10']})")
        if got != sets:
            raise AssertionError(f"64-bit phase: radius id sets differ from "
                                 f"the fp64 oracle's "
                                 f"({out['radius_set_recall']})")
        if min(out["launches"]["segmin_fp32"],
               out["launches"]["surface_fp32"]) == 0 or \
                out["launches"]["int8"]:
            raise AssertionError(f"64-bit phase: the fp32 K1 and K4 did not "
                                 f"both run alone ({out['launches']})")

        # the completeness flags of the batch of 64, up the escalation
        # ladder from the collection's margin hint until every flag is 1;
        # the proven rows must be the rows high returned
        state = coll._device_state()
        tq = torch.from_numpy(queries[:64]).to(dev)
        rows, first, margin = proven_rows(coll, tq, 64)
        if rows != [[x.id for x in res.results] for res in res64]:
            raise AssertionError("64-bit phase: proven rows differ from "
                                 "high's results")
        out["flags"] = {"first_rung_ok_frac": first, "all_ok": True,
                        "proven_margin": margin or scan.DEFAULT_TIE_MARGIN}

        # the fp32 kernels against their plain version in f64 on the
        # collection's own state at the batcher's group sizes (tiles 16, 32
        # and 64): here every persistent block walks several (query tile,
        # row tile) units, as on the main path
        codes, norms, valid = state["codes"], state["norms"], state["valid"]
        err = out["max_abs_err"] = {"segmin_fp32": 0.0, "surface_fp32": 0.0}
        for q in (16, 17, 64):
            qq = tq[:q].contiguous()
            qn2 = qq.square().sum(-1)
            for metric in ("cosine", "euclidean"):
                what = f"64-bit phase {metric} Q={q}"
                e, _ = segmin_error(
                    scan.segmin_fp32(qq, codes, norms, valid, bits=64,
                                     metric=metric, seg=32),
                    scan.segment_min_scan_plain(
                        qq, codes, norms, valid, bits=64, metric=metric,
                        dtype=torch.float64),
                    qn2, norms, valid, metric, DIMS, f"K1 {what}")
                err["segmin_fp32"] = max(err["segmin_fp32"], e)
                e, _ = surface_error(
                    scan.surface_fp32(qq, codes, norms, valid, bits=64,
                                      metric=metric, exact=True),
                    scan.score_surface_plain(
                        qq, codes, norms, valid, bits=64, metric=metric,
                        dtype=torch.float64),
                    qn2, norms, valid, metric, DIMS, f"K4 {what}", False)
                err["surface_fp32"] = max(err["surface_fp32"], e)

        # wall ms per batch (warm) beside the fp32 kernels' device ms on the
        # collection's state at the same query counts
        out["wall_ms"] = {
            "high_batch16": statistics.median(wall_ms(
                lambda: knn(queries[:16]), 7)),
            "high_batch64": statistics.median(wall_ms(
                lambda: knn(queries[:64]), 7)),
            "radius_high_batch16": statistics.median(wall_ms(radius, 5))}
        out["kernel_ms"] = {
            f"segmin_fp32_q{q}": cuda_ms(lambda: scan.segmin_fp32(
                tq[:q], codes, norms, valid, bits=64, metric="cosine",
                seg=32), reps=10) for q in (16, 64)}
        out["kernel_ms"]["surface_fp32_q16"] = cuda_ms(
            lambda: scan.surface_fp32(tq[:16], codes, norms, valid, bits=64,
                                      metric="cosine", exact=True), reps=10)
        coll.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"64-bit phase ({out['rows']} rows, quantization 64): {out}")
    report["e2e_64bit"] = out
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel times at the main path's shapes
# ---------------------------------------------------------------------------

FP32_CHECK_QS = (1, 16, 17, 64, 65, 128, 129)


def fp32_synthetic(bits: int, n: int, dev, dims: int = DIMS):
    """n x dims seeded synthetic codes at `bits` (64-bit: f32 codes), their
    decoded f32 values (affine-mapped for 4/16 bits), norms and 1% invalid
    rows."""
    from syzgydb_tpu_torch.ops import distance as dist_ops
    from syzgydb_tpu_torch.ops import quantize as qz

    gen = torch.Generator(device=dev)
    gen.manual_seed(bits)
    w = qz.device_width(bits, dims)
    if bits == 4:
        codes = torch.randint(0, 256, (n, w), generator=gen, device=dev,
                              dtype=torch.uint8)
    elif bits == 16:
        codes = torch.randint(-32768, 32768, (n, w), generator=gen,
                              device=dev, dtype=torch.int16)
    else:
        codes = torch.rand((n, w), generator=gen, device=dev) * 2 - 1
    vals = dist_ops.decode_codes(codes, bits, dims)
    if bits in (4, 16):
        scale, offset = qz.affine_constants(bits)
        vals = vals.mul_(scale).add_(offset)
    norms = vals.square().sum(1)
    valid = torch.rand(n, generator=gen, device=dev) > 0.01
    return codes, vals, norms, valid


def fp32_variant_checks(tq, codes, norms, valid, bits: int) -> dict:
    """Every query tile of the fp32 kernels on the first 262,144 rows (so
    that every persistent block walks several units at every tile): K1
    (seg 32) and K4 (f32 and bf16) at Q in FP32_CHECK_QS (tiles 16, 16,
    32, 64, 128, 128, 128 x 2), both metrics, held against the plain
    version in f64 (segmin_error / surface_error), and each launch repeated
    for a bit-identical output.  -> max |err| of K1 and of K4's f32
    surface, and the configurations checked."""
    from syzgydb_tpu_torch.ops import scan

    m = 1 << 18
    sub = (codes[:m], norms[:m], valid[:m])
    out = {"segmin_err": 0.0, "surface_err": 0.0, "runs": 0}
    for q in FP32_CHECK_QS:
        qq = tq[:q].contiguous()
        qn2 = qq.square().sum(-1)
        for metric in ("euclidean", "cosine"):
            what = f"fp32 {bits}-bit {metric} Q={q} (tile " \
                   f"{scan.fp32_query_tile(q)})"
            got = scan.segmin_fp32(qq, *sub, bits=bits, metric=metric,
                                   seg=32)
            if not torch.equal(got, scan.segmin_fp32(
                    qq, *sub, bits=bits, metric=metric, seg=32)):
                raise AssertionError(f"K1 not bit-identical across two "
                                     f"launches: {what}")
            err, _ = segmin_error(got, scan.segment_min_scan_plain(
                qq, *sub, bits=bits, metric=metric, dtype=torch.float64),
                qn2, sub[1], sub[2], metric, DIMS, f"K1 {what}")
            out["segmin_err"] = max(out["segmin_err"], err)
            want = scan.score_surface_plain(qq, *sub, bits=bits,
                                            metric=metric,
                                            dtype=torch.float64)
            for exact in (True, False):
                got = scan.surface_fp32(qq, *sub, bits=bits, metric=metric,
                                        exact=exact)
                if not torch.equal(got, scan.surface_fp32(
                        qq, *sub, bits=bits, metric=metric, exact=exact)):
                    raise AssertionError(f"K4 not bit-identical across two "
                                         f"launches: {what}")
                err, _ = surface_error(got, want, qn2, sub[1], sub[2],
                                       metric, DIMS,
                                       f"K4 {what} exact={exact}", not exact)
                if exact:
                    out["surface_err"] = max(out["surface_err"], err)
            out["runs"] += 3
            del got, want
    return out


def fp32_width_times(tq, dev, n: int = 1 << 20) -> dict:
    """The fp32 kernels at the widths the int8 route does not take (4, 32
    and 64 bits; 64-bit codes are f32 on the card), and at 16 bits, where
    K4 and rows past hilo_max_dims still take them and K1's int8 route
    (hilo_times) is measured against them, on n x 384 seeded
    synthetic codes: first every query tile held against the plain version
    (fp32_variant_checks), then K1 (csrc/segmin.cu, seg 32) at Q = 1024, 64
    and 16 and K4 (csrc/surface.cu, f32) at Q = 128 and 16, cosine, each
    timed beside the plain version, fp32 torch.matmul with TF32 off (the
    exact library yardstick) and bf16 torch.matmul (inexact) of the queries
    with the decoded codes, and its bound as the kernel table defines it:
    the operations over the bf16 tensor rate or the bytes at that width.
    Beside it, the bound at the fp32 FMA rate these kernels compute at
    (fp32_fma_bound_ms: the larger of the bytes and the operations over 67
    TFLOP/s), and for the integer codes (4 and 16 bits) the int8 route's
    floor.  Last, K1 on the 64-bit codes at Q = 16, 32 and 64 on every query
    tile that holds them (tile_sweep): what sets fp32_query_tile's cut
    points."""
    from syzgydb_tpu_torch.ops import scan

    d, out = DIMS, {"checks": {}}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for bits in (4, 16, 32, 64):
            codes, vals, norms, valid = fp32_synthetic(bits, n, dev)
            out["checks"][f"{bits}bit"] = fp32_variant_checks(
                tq, codes, norms, valid, bits)
            vb = vals.to(torch.bfloat16)
            code_bytes = codes.numel() * codes.element_size()
            for kind, qs in (("segmin", (1024, 64, 16)),
                             ("surface", (128, 16))):
                for q in qs:
                    qq = tq[:q].contiguous()
                    qb = qq.to(torch.bfloat16)
                    if kind == "segmin":
                        def kern():
                            return scan.segmin_fp32(
                                qq, codes, norms, valid, bits=bits,
                                metric="cosine", seg=32)

                        def plain():
                            return scan.segment_min_scan_plain(
                                qq, codes, norms, valid, bits=bits,
                                metric="cosine")
                        out_bytes = 4 * q * (n // 32)
                    else:
                        def kern():
                            return scan.surface_fp32(
                                qq, codes, norms, valid, bits=bits,
                                metric="cosine", exact=True)

                        def plain():
                            return scan.score_surface_plain(
                                qq, codes, norms, valid, bits=bits,
                                metric="cosine", exact=True)
                        out_bytes = 4 * q * n
                    ops = 2.0 * q * n * d
                    nbytes = code_bytes + 5 * n + 4 * q * d + out_bytes
                    row = out[f"{kind}_{bits}bit_q{q}"] = {
                        "tile": scan.fp32_query_tile(q),
                        "ms": cuda_ms(kern, reps=5),
                        "plain_ms": cuda_ms(plain, reps=1),
                        "library_fp32_ms": cuda_ms(lambda: qq @ vals.T,
                                                   reps=5),
                        "library_bf16_inexact_ms": cuda_ms(
                            lambda: qb @ vb.T, reps=3),
                        **bound(ops, nbytes),
                        "fp32_fma_bound_ms": bound(ops, nbytes,
                                                   FP32_FLOPS)["bound_ms"],
                        "fp32_fma_bound_by": bound(ops, nbytes,
                                                   FP32_FLOPS)["bound_by"]}
                    if bits in (4, 16):
                        # integer codes: the int8 route's 3 query slices
                        # against one int8 slice of a 4-bit code, or two of
                        # a 16-bit one
                        row["int8_floor_ms"] = scan.I8_SLICES * (
                            bits // 8 or 1) * ops / INT8_OPS * 1e3
            if bits == 64:
                sweep = torch.empty((64, n // 32), device=dev)
                out["tile_sweep"] = {
                    f"q{q}_tile{t}": cuda_ms(
                        lambda: scan._launch_fp32(
                            "segmin", sweep[:q], 32, tq[:q], codes, norms,
                            valid, bits=bits, metric="cosine", tile=t),
                        reps=5)
                    for q in (16, 32, 64) for t in scan.FP32_TILES if t >= q}
                del sweep
            del codes, vals, vb, norms, valid
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log("fp32 kernels: every query tile within its bound of f64 and "
        "bit-identical across launches: " + ", ".join(
            f"{k} {v['runs']} (K1 {v['segmin_err']:.3g}, K4 "
            f"{v['surface_err']:.3g})" for k, v in out["checks"].items()))
    log("fp32 kernels at the other widths (ms; fp32 FMA bound; fp32 mm): "
        + ", ".join(f"{k} {v['ms']:.4f} ({v['fp32_fma_bound_ms']:.3f}; "
                    f"{v['library_fp32_ms']:.3f})" for k, v in out.items()
                    if k not in ("checks", "tile_sweep")))
    log(f"fp32 K1 64-bit tile sweep (ms): {out['tile_sweep']}")
    return out


def hilo_times(tq, dev, n: int = 1 << 20) -> dict:
    """K1 (seg 32) on 16-bit codes by the int8 route (csrc/segmin_i8.cu,
    each code split into a high and a low byte in the kernel's load;
    launched directly, whichever kernel _route picks for the shape) on
    n x 384 seeded synthetic codes (fp32_synthetic) at Q = 1024, 64 and 16,
    cosine, and on n x 960 at Q = 1024, Euclidean (the GIST cell's launch):
    each launch at the size it is timed at first held both ways (i8_checks,
    whose f64 plain versions go in row blocks) and for two bit-identical
    launches, then timed beside the plain version, the fp32 kernel
    (csrc/segmin.cu) on the same inputs, fp32 torch.matmul with TF32 off
    (the library yardstick) and bf16 torch.matmul (inexact) of the queries
    with the decoded codes, with its bound as the kernel table defines it
    and the 16-bit int8 floor, 2*6*Q*N*D at 1,979 TOP/s.  `launches` is
    what scan.i8_hilo_launches counted over the whole phase."""
    from syzgydb_tpu_torch.ops import scan

    out = {"max_abs_err": 0.0, "max_err_over_ulp_bound": 0.0, "runs": 0}
    start = scan.i8_hilo_launches
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for d, metric, qs in ((DIMS, "cosine", (1024, 64, 16)),
                              (960, "euclidean", (1024,))):
            codes, vals, norms, valid = fp32_synthetic(16, n, dev, d)
            vb = vals.to(torch.bfloat16)
            qv = torch.randn((1024, d), generator=torch.Generator(
                device=dev).manual_seed(d), device=dev)
            inputs = (codes, norms, valid)

            def k1(qq):
                return scan._segmin_i8(qq, *inputs, bits=16, metric=metric,
                                       seg=32)[0]
            for q in qs:
                qq = qv[:q].contiguous()
                qb = qq.to(torch.bfloat16)
                what = f"K1 int8 16-bit D={d} {metric} Q={q}"
                before = scan.i8_hilo_launches
                got = k1(qq)
                if scan.i8_hilo_launches != before + 1:
                    raise AssertionError(f"{what}: not counted")
                if not torch.equal(got, k1(qq)):
                    raise AssertionError(f"not bit-identical across two "
                                         f"launches: {what}")
                err, _, ulps = i8_checks(got, qq, *inputs, metric, d, what,
                                         bits=16)
                del got
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["max_err_over_ulp_bound"] = max(
                    out["max_err_over_ulp_bound"], ulps)
                out["runs"] += 1
                ops = 2.0 * q * n * d
                out[f"segmin_i8_16bit_d{d}_q{q}"] = {
                    "ms": cuda_ms(lambda: k1(qq), reps=5),
                    "fp32_kernel_ms": cuda_ms(lambda: scan.segmin_fp32(
                        qq, *inputs, bits=16, metric=metric, seg=32),
                        reps=3),
                    "plain_ms": cuda_ms(lambda: scan.segment_min_scan_plain(
                        qq, *inputs, bits=16, metric=metric), reps=1),
                    "library_fp32_ms": cuda_ms(lambda: qq @ vals.T, reps=5),
                    "library_bf16_inexact_ms": cuda_ms(lambda: qb @ vb.T,
                                                       reps=3),
                    "int8_floor_ms": 2 * scan.I8_SLICES * ops / INT8_OPS * 1e3,
                    **bound(ops, 2 * n * d + 5 * n + 4 * q * d +
                            4 * q * (n // 32))}
            del codes, vals, vb, norms, valid, inputs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["launches"] = scan.i8_hilo_launches - start
    log(f"K1 int8 16-bit: {out['runs']} configurations within delta of "
        f"f64 and within 4 ulps on q_hat (max |err| "
        f"{out['max_abs_err']:.3g}, max err/bound "
        f"{out['max_err_over_ulp_bound']:.3g}), {out['launches']} launches; "
        f"ms " + ", ".join(
            f"{k[16:]} {v['ms']:.3f} (fp32 kernel {v['fp32_kernel_ms']:.3f}, "
            f"fp32 mm {v['library_fp32_ms']:.3f}, int8 floor "
            f"{v['int8_floor_ms']:.3f}, bound {v['bound_ms']:.3f})"
            for k, v in out.items() if k.startswith("segmin_")))
    return out


def filtered_k1_times(dev, n: int = 1 << 20, d: int = 768, q: int = 1024,
                      passing: tuple = (990_000, 1_000_000)) -> dict:
    """K1 (8-bit codes, seg 32, cosine; the resident int8 kernel at this
    width) at the filtered cell's launch: 1M rows of capacity x 768 and
    Q = 1024, over a validity column that passes only rows [990,000,
    1,000,000), the 1% that `i >= 990000` keeps, so 99% of the segments are
    wholly invalid.  Seeded random codes; launched through
    segment_min_scan, the main path's entry, with scan.i8_launches reset
    just before and read after (one launch); held both ways against the
    f64 plain version in row blocks (i8_checks: identical +inf segments,
    within delta and within 4 ulps on q_hat) and for two bit-identical
    launches, then timed beside the plain version and its bound."""
    from syzgydb_tpu_torch.ops import quantize as qz
    from syzgydb_tpu_torch.ops import scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(d + 8)
    codes = torch.randint(-128, 128, (n, d), generator=gen, device=dev,
                          dtype=torch.int8)
    scale, offset = qz.affine_constants(8)
    norms = (codes.float() * scale + offset).square().sum(1)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    valid[passing[0]:passing[1]] = True
    qq = torch.randn((q, d), generator=gen, device=dev)
    what = f"K1 int8 8-bit D={d} cosine Q={q}, rows {passing} valid"

    def k1():
        return scan.segment_min_scan(qq, codes, norms, valid, bits=8,
                                     metric="cosine")
    scan.i8_launches = 0
    got = k1()
    launched = scan.i8_launches
    if launched != 1:
        raise AssertionError(f"{what}: {launched} int8 launches counted")
    if not torch.equal(got, k1()):
        raise AssertionError(f"not bit-identical across two launches: "
                             f"{what}")
    finite = int(torch.isfinite(got[0]).sum())
    err, ratio, ulps = i8_checks(got, qq, codes, norms, valid, "cosine", d,
                                 what)
    del got
    ops = 2.0 * q * n * d
    out = {"launches": launched, "finite_segments": finite,
           "max_abs_err": err, "max_err_over_bound": ratio,
           "max_err_over_ulp_bound": ulps,
           "ms": cuda_ms(k1, reps=5),
           "plain_ms": cuda_ms(lambda: scan.segment_min_scan_plain(
               qq, codes, norms, valid, bits=8, metric="cosine"), reps=1),
           "int8_floor_ms": scan.I8_SLICES * ops / INT8_OPS * 1e3,
           **bound(ops, n * d + 5 * n + 4 * q * d + 4 * q * (n // 32))}
    log(f"{what}: {launched} launch, {finite} of {n // 32} segments finite; "
        f"within delta of f64 (max |err| {err:.3g}, max err/delta "
        f"{ratio:.3g}) and within 4 ulps on q_hat (max err/bound "
        f"{ulps:.3g}); ms {out['ms']:.4f} (plain {out['plain_ms']:.3f}, "
        f"int8 floor {out['int8_floor_ms']:.4f}, bound "
        f"{out['bound_ms']:.4f})")
    return out


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


# ---------------------------------------------------------------------------
# phase 4b: the tools (export, import, Go .dat migration) on the card
# ---------------------------------------------------------------------------

# the float-text round trip's rows, cut from the 64-bit phase's 262,144:
# text export writes ~20 characters a float (12.6 M floats: ~250 MB)
TEXT_ROWS = 1 << 15
# the Go .dat migration's rows: the 1M collection's first ids
REF_ROWS = 1 << 17


class DumpTally:
    """A dump_index sink that counts record lines instead of keeping the
    text: records, records whose CRC holds, tombstones."""

    def __init__(self):
        self.records = self.crc_ok = self.tombstones = 0

    def write(self, line: str) -> None:
        if line.startswith("  ["):
            self.records += 1
            self.crc_ok += line.rstrip().endswith("crc=ok")
            self.tombstones += " TOMBSTONE " in line


def same_results(got, want, what: str) -> None:
    """Equal ids in equal order and bit-equal f32 distances."""
    for g, w in zip(got, want, strict=True):
        if [(x.id, x.distance) for x in g.results] != \
                [(x.id, x.distance) for x in w.results]:
            raise AssertionError(f"tools {what}: the copy's results differ "
                                 f"from the source's")


def round_trip(coll, folder: str, name: str, compact: bool, dev):
    """export_json to a file, import_json of it into a new collection on
    `dev`, the file removed -> (copy, times and sizes)."""
    from syzgydb_tpu_torch.tools import dump

    path = os.path.join(folder, f"{name}.json")
    n = coll.get_document_count()
    t0 = time.perf_counter()
    with open(path, "w") as f:
        dump.export_json(coll, f, compact=compact)
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    with open(path) as f:
        copy = dump.import_json(os.path.join(folder, f"{name}.dat"), f,
                                device=dev)
    import_s = time.perf_counter() - t0
    os.remove(path)
    return copy, {
        "rows": n, "export_bytes": nbytes, "export_s": export_s,
        "export_rows_per_s": n / export_s,
        "export_mb_per_s": nbytes / export_s / 1e6, "import_s": import_s,
        "import_rows_per_s": n / import_s,
        "import_mb_per_s": nbytes / import_s / 1e6}


def tools_phase(coll, rows_text: np.ndarray, queries: np.ndarray, dev,
                card: str, report: dict) -> None:
    """Phase 4b: the tools on the card, their launch counters reset before
    and read after.  (1) The 1M collection exported compact and imported
    into a new collection on the card: high batch 1024 with equal ids,
    bit-equal distances and every flag 1, medium batch 8 (K2) equal, equal
    device sketches and counts, and dump_index of the copy's file finding
    every record with a good CRC.  (2) A 32,768 x 384 quantization-64
    collection from the corpus's first rows exported as float text and
    imported: high batch 16 (fp32 K1 at tile 16) equal likewise.  (3) A
    Go .dat of the 1M collection's first 131,072 rows (build_ref_file,
    8-bit, FREE gaps) migrated with import_ref_file: each query's top-10
    equals the source's under "i < 131072", ids as sets (rows tied at the
    10th distance aside) and sorted distances bit-equal.  Every temp file
    is removed."""
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.tools import dump, refimport

    def args(qs, precision, **kw):
        return [tdb.SearchArgs(vector=q, k=K, precision=precision, **kw)
                for q in qs]

    tmp = tempfile.mkdtemp(prefix="syzgy_tools_")
    out = {"card": card, "reduced": {
        "text_round_trip_rows": f"{TEXT_ROWS} (from 262,144: float text "
                                f"writes ~20 characters a float)",
        "ref_rows": f"{REF_ROWS} (the 1M collection's first ids)"}}
    copies = []
    t_phase = time.perf_counter()
    reset_counters()
    try:
        # (1) the compact round trip of the 1M collection
        copy, c1 = round_trip(coll, tmp, "compact", True, dev)
        out["compact"] = c1
        copies.append(copy)
        tq = torch.from_numpy(queries).to(dev)
        # the margin hint is derived state: start the copy where the source
        # stands, so both rerank the same candidates
        copy._seg_margin_hint = coll._seg_margin_hint
        t0 = time.perf_counter()
        got = copy.search_many(args(queries, "high"))
        c1["first_batch1024_ms"] = (time.perf_counter() - t0) * 1000.0
        same_results(got, coll.search_many(args(queries, "high")),
                     "compact high batch 1024")
        rows, c1["first_rung_ok_frac"], _ = proven_rows(copy, tq, 8)
        if rows != [[x.id for x in r.results] for r in got]:
            raise AssertionError("tools compact: proven rows differ from "
                                 "the copy's high results")
        same_results(copy.search_many(args(queries[:8], "medium")),
                     coll.search_many(args(queries[:8], "medium")),
                     "compact medium batch 8")
        if not torch.equal(copy._device_state()["hashes"],
                           coll._device_state()["hashes"]):
            raise AssertionError("tools compact: the copy's sketches differ")
        if copy.get_document_count() != coll.get_document_count():
            raise AssertionError("tools compact: document counts differ")
        tally = DumpTally()
        t0 = time.perf_counter()
        dump.dump_index(copy.options.name, tally)
        c1["dump_s"] = time.perf_counter() - t0
        c1["dump_records"] = tally.records
        if (tally.records, tally.crc_ok, tally.tombstones) != \
                (c1["rows"] + 1, c1["rows"] + 1, 0):
            raise AssertionError(f"tools dump_index: {vars(tally)} for "
                                 f"{c1['rows']} rows and the options record")

        # (2) the float-text round trip at the server's default width
        src = tdb.Collection(tdb.CollectionOptions(
            name=os.path.join(tmp, "text_src.dat"),
            distance_method=tdb.COSINE, dimension_count=DIMS,
            quantization=64, index_seed=4242), device=dev)
        copies.append(src)
        src.add_documents(list(range(len(rows_text))), rows_text,
                          [b'{"i":%d}' % i for i in range(len(rows_text))])
        copy, c2 = round_trip(src, tmp, "text", False, dev)
        out["text"] = c2
        copies.append(copy)
        copy._seg_margin_hint = src._seg_margin_hint
        t0 = time.perf_counter()
        got = copy.search_many(args(queries[:16], "high"))
        c2["first_batch16_ms"] = (time.perf_counter() - t0) * 1000.0
        same_results(got, src.search_many(args(queries[:16], "high")),
                     "text high batch 16")
        rows, c2["first_rung_ok_frac"], _ = proven_rows(copy, tq[:16], 64)
        if rows != [[x.id for x in r.results] for r in got]:
            raise AssertionError("tools text: proven rows differ from the "
                                 "copy's high results")

        # (3) the Go .dat migration of the 1M collection's first rows
        t0 = time.perf_counter()
        records = []
        for ids, vecs, metas in coll.iter_export_rows():
            records += [(i, v, m) for i, v, m in zip(ids, vecs, metas)
                        if i < REF_ROWS]
            if ids[-1] >= REF_ROWS - 1:
                break
        blob = refimport.build_ref_file(
            {"name": "smoke.dat", "distance_method": tdb.COSINE,
             "dimension_count": DIMS, "quantization": 8}, records, 8,
            free_gaps=True)
        del records
        dat = os.path.join(tmp, "ref.dat")
        with open(dat, "wb") as f:
            f.write(blob)
        c3 = out["ref"] = {"rows": REF_ROWS, "dat_bytes": len(blob),
                           "write_s": time.perf_counter() - t0}
        del blob
        t0 = time.perf_counter()
        copy = refimport.import_ref_file(dat, os.path.join(tmp, "ref_n.dat"),
                                         device=dev)
        c3["import_s"] = time.perf_counter() - t0
        c3["import_rows_per_s"] = REF_ROWS / c3["import_s"]
        copies.append(copy)
        os.remove(dat)
        if copy.get_document_count() != REF_ROWS:
            raise AssertionError(f"tools ref: {copy.get_document_count()} "
                                 f"records imported")
        got = copy.search_many(args(queries[:64], "high"))
        want = coll.search_many(args(queries[:64], "high",
                                     filter_query=f"i < {REF_ROWS}"))
        strict = 0
        for g, w in zip(got, want, strict=True):
            gd = sorted(x.distance for x in g.results)
            if gd != sorted(x.distance for x in w.results):
                raise AssertionError("tools ref: sorted distances differ")
            # rows tied at the 10th distance may be either
            cut = gd[-1]
            if {x.id for x in g.results if x.distance < cut} != \
                    {x.id for x in w.results if x.distance < cut}:
                raise AssertionError("tools ref: top-10 ids differ")
            strict += {x.id for x in g.results} != \
                {x.id for x in w.results}
        c3["queries_with_tied_sets"] = strict
    finally:
        for c in copies:
            c.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    c = counters()
    out["launches"] = {"segmin_i8": c["segmin_i8"],
                       "segmin_fp32": c["segmin"] - c["segmin_i8"],
                       "hamming": c["hamming"], "hamming_u8": c["hamming_u8"],
                       "surface": c["surface"],
                       "segmin_free_seg": c["segmin_free_seg"]}
    out["phase_s"] = time.perf_counter() - t_phase
    if min(out["launches"][k] for k in ("segmin_i8", "segmin_fp32",
                                        "hamming")) == 0:
        raise AssertionError(f"tools phase: K1 (int8), fp32 K1 or K2 not "
                             f"launched ({out['launches']})")
    log(f"tools: {out}")
    print(json.dumps({"tools": out}), flush=True)
    report["tools"] = out


# ---------------------------------------------------------------------------
# phase 5: the on-device text embedder (embedder: device)
# ---------------------------------------------------------------------------

EMB_DOCS, EMB_POST = 1 << 17, 1024
EMB_BATCHES = (1, 16, 64, 256, 1024)
EMB_CLIENTS, EMB_PER_CLIENT = 32, 16


def corpus_docs(n: int, seed: int) -> tuple[list, list]:
    """n documents of the synthetic topical corpus and their topics."""
    from syzgydb_tpu_torch.models import train_synthetic as ts

    topics, filler = ts.make_vocab()
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, ts.N_TOPICS, size=n).tolist()
    return [ts.sample_doc(rng, topics[t], filler) for t in picks], picks


def forward_ops(cfg, n_texts: int) -> float:
    """One forward's operations over n_texts at max_len tokens: the dense
    layers' and attention's products, 2 operations a multiply-add."""
    seq, h = cfg.max_len, cfg.hidden
    dense = 2 * seq * (4 * h * h + 2 * h * cfg.mlp_dim)
    attn = 4 * seq * seq * h
    return float(n_texts * cfg.layers * (dense + attn))


def embed_bound(cfg, n_params: int, n_texts: int) -> dict:
    """The bound of one forward of n_texts: forward_ops over the bf16
    tensor rate, beside every weight read once in bf16 over the memory
    rate."""
    ops = forward_ops(cfg, n_texts)
    out = bound(ops, 2 * n_params)
    out.update(gflop=ops / 1e9, weight_mb=2 * n_params / 1e6)
    return out


def embed_full_width(dev) -> dict:
    """(1) Both archs at full width with seeded random weights: bf16 on the
    card against f32 on the CPU, same weights and texts.  The tolerance is
    derived from the CPU alone: twice the largest error of the CPU's own
    bf16 run against its f32 run."""
    from syzgydb_tpu_torch.models.embedder import EmbedderConfig, TextEmbedder

    texts = corpus_docs(29, 5)[0] + ["", "a " * 300, "Hello, World! 123"]
    out = {}
    for arch, eps in (("preln", 1e-6), ("bert", 1e-12)):
        run = {}
        for dt, where in (("float32", "cpu"), ("bfloat16", "cpu"),
                          ("bfloat16", dev)):
            emb = TextEmbedder(EmbedderConfig(arch=arch, ln_eps=eps,
                                              dtype=dt), seed=11,
                               device=where)
            run[dt, str(where)] = emb.embed(texts)
        want = run["float32", "cpu"]
        cpu16, card = run["bfloat16", "cpu"], run["bfloat16", str(dev)]
        tol = 2.0 * float(np.abs(cpu16 - want).max())
        err = float(np.abs(card - want).max())
        out[arch] = {"texts": len(texts), "tolerance": tol,
                     "max_abs_err": err,
                     "min_cos": float((card * want).sum(1).min()),
                     "cpu_bf16_max_abs_err": tol / 2.0,
                     "cpu_bf16_min_cos": float((cpu16 * want).sum(1).min())}
        log(f"embedder full width {arch}: {out[arch]}")
        if not np.isfinite(card).all() or err > tol:
            raise AssertionError(f"embedder {arch}: the card's bf16 run is "
                                 f"{err} from the CPU's f32, tolerance {tol}")
    return out


def embed_times(dev) -> dict:
    """Full-width preln in bf16 on the card: the forward alone (CUDA
    events over back-to-back forwards of pre-tokenized batches) and the
    whole embed() call (host clock: tokenizing, copies and the result's
    fetch) at each batch, each beside its bound; then torch.profiler over
    the largest batch's forward and over one batch-1 embed() (a text
    search embeds its text alone): kernel time by name, device ops."""
    from syzgydb_tpu_torch.models.embedder import TextEmbedder

    emb = TextEmbedder(seed=0, device=dev)
    n_params = sum(p.numel() for p in emb.model.parameters())
    docs = corpus_docs(max(EMB_BATCHES), 6)[0]
    out = {"n_params": n_params, "max_len": emb.cfg.max_len, "batches": {}}
    with torch.inference_mode():
        for b in EMB_BATCHES:
            ids, mask = emb.tokenizer.batch_encode(docs[:b])
            ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
            mask = torch.from_numpy(mask).to(dev)
            fwd = cuda_ms(lambda: emb._net(ids, mask),
                          reps=20 if b < 256 else 5)
            wall = float(np.median(wall_ms(lambda: emb.embed(docs[:b]),
                                           reps=10 if b < 256 else 3)))
            row = {"forward_ms": fwd, "embed_ms": wall,
                   "texts_per_s": b / wall * 1e3,
                   **embed_bound(emb.cfg, n_params, b)}
            out["batches"][b] = row
            log(f"embed batch {b}: {row}")
        # where a forward's device time goes, and a lone text's launches
        out["profile"] = profile_batches(None, [
            (f"forward_{b}", lambda: emb._net(ids, mask)),
            ("embed_1", lambda: emb.embed(docs[:1]))])
    return out


def embed_gate(dev) -> dict:
    """(2) The shipped checkpoint on the card clears the retrieval gate;
    random weights of its config do not."""
    from syzgydb_tpu_torch.models import train_synthetic as ts
    from syzgydb_tpu_torch.models.embedder import TextEmbedder

    trained = ts.retrieval_accuracy(
        TextEmbedder.from_checkpoint(ts.DEFAULT_CHECKPOINT, device=dev),
        n_queries=48)
    rnd = ts.retrieval_accuracy(
        TextEmbedder(ts.training_config(), seed=123, device=dev), seed=777,
        n_queries=48)
    log(f"embedder gate: trained {trained}, random {rnd}")
    if trained < 0.9 or rnd >= 0.5:
        raise AssertionError(f"embedder gate: trained {trained} (>= 0.9), "
                             f"random {rnd} (< 0.5)")
    return {"trained": trained, "random": rnd}


class EmbedServer:
    """The port's REST server with embedder: device on `dev`, in the empty
    data folder `folder`; the config and the embed_text seam come back on
    close."""

    def __init__(self, folder: str, dev, checkpoint: str = ""):
        from syzgydb_tpu_torch.server import config, embedding, rest

        self.config, self.embedding = config, embedding
        self.old = config.global_config, embedding.get_embed_text()
        config.global_config = config.Config(
            data_folder=folder, html_root="", embedder="device",
            embedder_checkpoint=checkpoint)
        try:
            self.srv = rest.make_server(folder, device=dev)
            self.httpd, self.port = start_http(self.srv)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if hasattr(self, "httpd"):
            self.httpd.shutdown()
            self.httpd.server_close()
            for c in self.srv.collections.values():
                c.close()
        self.config.global_config = self.old[0]
        self.embedding.set_embed_text(self.old[1])


def embed_rest_flow(dev) -> dict:
    """(3) tests/test_embedder.py's REST flow on the card: the shipped
    checkpoint, 12 text inserts at quantization 16, 12 held-out text
    queries, each must find its document's topic top-1 (>= 11 of 12)."""
    from syzgydb_tpu_torch.models import train_synthetic as ts

    folder = tempfile.mkdtemp(prefix="syzgy_embed_flow_")
    es = EmbedServer(folder, dev, ts.DEFAULT_CHECKPOINT)
    try:
        base = "/api/v1/collections"
        http_call(es.port, "POST", base, {
            "name": "txt", "vector_size": ts.training_config().hidden,
            "quantization": 16, "distance_function": "cosine"}, 201)
        topics, filler = ts.make_vocab()
        rng = np.random.default_rng(31)
        doc_topics = list(range(0, 36, 3))
        http_call(es.port, "POST", f"{base}/txt/records", [
            {"id": i, "text": ts.sample_doc(rng, topics[t], filler),
             "metadata": {"topic": t}} for i, t in enumerate(doc_topics)],
            201)
        hits = 0
        for t in doc_topics:
            res = http_call(es.port, "POST", f"{base}/txt/search", {
                "text": ts.sample_doc(rng, topics[t], filler), "k": 1})
            hits += int(res["results"][0]["metadata"]["topic"] == t)
    finally:
        es.close()
        shutil.rmtree(folder, ignore_errors=True)
    log(f"embedder REST flow: {hits} of 12 top-1")
    if hits < 11:
        raise AssertionError(f"embedder REST flow: {hits} of 12 top-1")
    return {"top1_hits": hits, "of": 12}


def medium_bounds(coll, qvecs, vecs64):
    """What any medium answer of `coll` may hold, per query: medium reranks
    the `budget` rows of least Hamming count, so every candidate set holds
    the rows below the budget's count (`sure`) and some of those at it
    (`tied`); the CPU and CUDA torch.topk pick different tied rows.  Counts
    by the plain K2 on the host; `vecs64[i]` is record i's vector.  -> per
    query (sure, sure + tied, fp64 top-10 of sure, fp64 top-10 of sure +
    tied), as sets of ids."""
    from syzgydb_tpu_torch.ops import hamming_scan

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


def embed_at_scale(dev, tol: float) -> dict:
    """(4) EMB_DOCS corpus documents inserted as text through the REST
    server (embedder: device, full-width preln, random weights from seed
    0) in POSTs of EMB_POST records into a 384-d cosine collection at
    quantization 8; then EMB_CLIENTS keep-alive clients each send
    EMB_PER_CLIENT high text searches (k = 10), after a warm-up pass of
    two each, and one client sends 16 default-precision (medium) text
    searches: lone queries below the scan crossover, on the sketch index
    (K2).  High must return the fp64 oracle's top-10 over the stored rows,
    for the query vector the handler computes (the text embedded alone);
    medium's ids may differ from the exact top-10 only through rows tied
    at the sketch budget's Hamming count (medium_bounds).  K1's int8 route
    and K2 must launch in this step: the counters are reset before it and
    read after."""
    import http.client

    from syzgydb_tpu_torch.server import embedding

    folder = tempfile.mkdtemp(prefix="syzgy_embed_scale_")
    docs, topics = corpus_docs(EMB_DOCS, 2024)
    queries = corpus_docs(EMB_CLIENTS * EMB_PER_CLIENT + 16, 4048)[0]
    out = {"docs": EMB_DOCS, "post": EMB_POST}
    reset_counters()
    es = EmbedServer(folder, dev)
    try:
        seam = embedding.get_embed_text()
        spent, searched = [], {}

        def timed(texts, use_cache):
            t0 = time.perf_counter()
            vecs = seam(texts, use_cache)
            if use_cache:  # a search: its text, embedded alone
                searched[texts[0]] = vecs[0]
            else:
                spent.append(time.perf_counter() - t0)
            return vecs

        embedding.set_embed_text(timed)
        base = "/api/v1/collections"
        http_call(es.port, "POST", base, {
            "name": "text", "vector_size": DIMS, "quantization": 8,
            "distance_function": "cosine"}, 201)
        conn = http.client.HTTPConnection("127.0.0.1", es.port, timeout=600)
        t0 = time.perf_counter()
        for a in range(0, EMB_DOCS, EMB_POST):
            conn.request("POST", f"{base}/text/records", body=json.dumps([
                {"id": i, "text": docs[i], "metadata": {"topic": topics[i]}}
                for i in range(a, min(a + EMB_POST, EMB_DOCS))]),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 201:
                raise AssertionError(f"embedder insert: HTTP {resp.status}: "
                                     f"{data[:300]!r}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        conn.close()
        out["insert"] = {"wall_s": wall, "docs_per_s": EMB_DOCS / wall,
                         "embed_s": sum(spent), "posts": len(spent)}
        log(f"embedder insert: {out['insert']}")
        coll = es.srv.collections["text"]
        path = f"{base}/text/search"

        def bodies(a, n, **kw):
            return [[{"text": queries[a + c * n + r], "k": K, **kw}
                     for r in range(n)] for c in range(EMB_CLIENTS)]

        http_clients(es.port, bodies(0, 2, precision="high"), path)
        res, lat, qwall, steady = http_clients(
            es.port, bodies(0, EMB_PER_CLIENT, precision="high"), path)
        res = [x for c in res for x in c]
        torch.cuda.synchronize()
        after_high = counters()
        n_high = EMB_CLIENTS * EMB_PER_CLIENT
        med_texts = queries[n_high:n_high + 16]
        med, med_lat, _, _ = http_clients(
            es.port, [[{"text": t, "k": K} for t in med_texts]], path)
        med = med[0]
        torch.cuda.synchronize()
        launches = counters()
        out["launches_in_medium"] = {k: launches[k] - after_high[k]
                                     for k in launches}
        # the query vectors the handlers searched with (each text embedded
        # alone), and the same texts embedded alone again here
        qv = np.array([searched[t] for t in queries[:n_high]], np.float32)
        mqv = np.array([searched[t] for t in med_texts], np.float32)
        again = np.array([seam([t], True)[0] for t in queries[:n_high]] +
                         [seam([t], True)[0] for t in med_texts], np.float32)
        out["query_vectors_recomputed_max_abs_diff"] = float(
            np.abs(again - np.concatenate([qv, mqv])).max())
        oracle = oracle_vectors(coll, dev)
        truth = oracle_top10(oracle, qv)
        rec = serve_recall(res, truth)
        med_rec = serve_recall(med, oracle_top10(oracle, mqv))
        vecs64 = np.zeros((EMB_DOCS, DIMS))
        vecs64[oracle[2].cpu().numpy()] = oracle[0].cpu().numpy()
        del oracle
        outside = 0
        for x, (sure, tied, top_sure, top_all) in zip(
                med, medium_bounds(coll, mqv, vecs64)):
            got = {r["id"] for r in x["results"]}
            outside += not (got <= tied and top_all & sure <= got and
                            got & sure <= top_sure)
        emb_ms = [x["embedding_time"] for x in res]
        out["search_high"] = {
            "requests": n_high, "clients": EMB_CLIENTS, "wall_s": qwall,
            "qps": n_high / qwall, "steady_qps": steady,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(np.mean(lat)),
            "mean_embedding_time_ms": float(np.mean(emb_ms)),
            "mean_search_time_ms": float(np.mean([x["search_time"]
                                                  for x in res])),
            "mean_queue_wait_time_ms": float(np.mean(
                [x["queue_wait_time"] for x in res])),
            "recall_at_10": rec}
        out["search_medium_one_client"] = {
            "requests": len(med), "p50_ms": float(np.percentile(med_lat, 50)),
            "mean_embedding_time_ms": float(np.mean(
                [x["embedding_time"] for x in med])),
            "recall_at_10": med_rec, "outside_tie_bounds": outside}
        out["launches"] = launches
    finally:
        es.close()
        shutil.rmtree(folder, ignore_errors=True)
    log(f"embedder at scale: {out}")
    if out["query_vectors_recomputed_max_abs_diff"] > tol:
        raise AssertionError(f"embedder: a query embedded again differs from "
                             f"the handler's by more than {tol}")
    if rec < 1.0:
        raise AssertionError(f"embedder text search high: recall {rec}")
    if outside:
        raise AssertionError(f"embedder text search medium: {outside} "
                             f"answers outside the sketch budget's ties")
    if min(after_high["segmin_i8"],
           out["launches_in_medium"]["hamming"]) == 0:
        raise AssertionError(f"embedder path: K1 (int8) at high or K2 at "
                             f"medium not launched ({launches}, "
                             f"{out['launches_in_medium']})")
    return out


def embedder_phase(dev, report: dict) -> None:
    """Phase 5: the on-device embedder on the card (see embed_full_width,
    embed_gate, embed_rest_flow, embed_at_scale, embed_times)."""
    t0 = time.perf_counter()
    out = {"full_width": embed_full_width(dev), "gate": embed_gate(dev),
           "rest_flow": embed_rest_flow(dev)}
    out["scale"] = embed_at_scale(dev, out["full_width"]["preln"]["tolerance"])
    out["times"] = embed_times(dev)
    out["phase_s"] = time.perf_counter() - t0
    report["embedder"] = out


# ---------------------------------------------------------------------------
# phase 6: training the embedder (train_synthetic) on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS = 400  # train_synthetic.main's default: the reference's run
TRAIN_BATCHES = (16, 64, 256)  # full-width step times
# the CPU test's bounds (tests/test_torch_train.py)
GRAD_F32_REL, KEY_BIAS_ATOL, SGD_ATOL = 1e-5, 1e-6, 1e-6
TRAIN_LOSS_RTOL = 1e-4
LOSS_BF16_RTOL, GRAD_BF16_COS = 1e-3, 0.99


def train_batch(tok, seed: int, pairs: int) -> tuple:
    """(ids_a, mask_a, ids_b, mask_b) as numpy: `pairs` synthetic-corpus
    pairs drawn as train_synthetic.train draws a batch (distinct topics up
    to 64, then the topics again)."""
    from syzgydb_tpu_torch.models import train_synthetic as ts

    topics, filler = ts.make_vocab()
    rng = np.random.default_rng(seed)
    picks = np.concatenate([rng.permutation(ts.N_TOPICS)
                            for _ in range(-(-pairs // ts.N_TOPICS))])
    picks = picks[:pairs]
    a = [ts.sample_doc(rng, topics[t], filler) for t in picks]
    b = [ts.sample_doc(rng, topics[t], filler) for t in picks]
    return (*tok.batch_encode(a), *tok.batch_encode(b))


def named_grads(model, batch) -> tuple[float, dict]:
    from syzgydb_tpu_torch.models import embedder as te

    loss, grads = te.loss_and_grads(model, *batch)
    return float(loss), {n: g.float().cpu().numpy() for (n, _), g in
                         zip(model.named_parameters(), grads)}


def key_third(cfg) -> slice:
    """The key bias's third of attn.qkv.bias: its true gradient is zero
    (softmax over the keys is invariant to q . b_k)."""
    return slice(cfg.hidden, 2 * cfg.hidden)


def tf32_watch(model) -> dict:
    """Record torch.backends.cuda.matmul.allow_tf32 at every Dense layer's
    forward and at its output's gradient in the backward."""
    from syzgydb_tpu_torch.models import embedder as te

    seen = {"forward": [], "backward": [], "handles": []}

    def hook(mod, args, out):
        seen["forward"].append(torch.backends.cuda.matmul.allow_tf32)
        out.register_hook(lambda g: seen["backward"].append(
            torch.backends.cuda.matmul.allow_tf32))

    for m in model.modules():
        if isinstance(m, te.Dense):
            seen["handles"].append(m.register_forward_hook(hook))
    return seen


def train_f32_parity(dev) -> dict:
    """(1) training_config() (f32) with the same seeded weights on the card
    and on the CPU: the loss and every gradient tensor of a batch of 48
    pairs (within 1e-4 relative and 1e-5 of the tensor's max |g|; the key
    third of attn.qkv.bias <= 1e-6 in both, its true gradient being 0),
    one SGD step at lr 1e-2 (every parameter within 1e-6), then 5 AdamW
    steps at lr 1e-3 (losses within 1e-4 relative).  The caller's TF32
    switch is set on first: every Dense forward and backward must still
    run with it off, and it must be on again after."""
    from syzgydb_tpu_torch.models import embedder as te
    from syzgydb_tpu_torch.models import train_synthetic as ts

    embs = {w: te.TextEmbedder(ts.training_config(), seed=3, device=w)
            for w in ("cpu", dev)}
    models = {w: e.train_model() for w, e in embs.items()}
    cfg, tok = embs["cpu"].cfg, embs["cpu"].tokenizer
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    watch = tf32_watch(models[dev])
    try:
        batch = train_batch(tok, 21, 48)
        (lc, gc), (lg, gg) = (named_grads(models[w], batch)
                              for w in ("cpu", dev))
        grad_rel = {k: float(np.abs(gg[k] - gc[k]).max() /
                             np.abs(gc[k]).max()) for k in gc}
        key = key_third(cfg)
        key_abs = max(float(np.abs(g[k][key]).max()) for g in (gc, gg)
                      for k in g if k.endswith("attn.qkv.bias"))
        sgd = {w: te.train_step(models[w], *batch, lr=1e-2)
               for w in ("cpu", dev)}
        sd = {w: {k: v.detach().cpu().numpy()
                  for k, v in models[w].state_dict().items()}
              for w in ("cpu", dev)}
        sgd_abs = max(float(np.abs(sd[dev][k] - sd["cpu"][k]).max())
                      for k in sd["cpu"])
        opts = {w: te.make_optimizer(models[w].parameters(), 1e-3)
                for w in ("cpu", dev)}
        adam = []
        for step in range(5):
            b = train_batch(tok, 30 + step, 48)
            adam.append([float(te.adamw_step(models[w], opts[w], *b))
                         for w in ("cpu", dev)])
        torch.cuda.synchronize()
        tf32_after = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        for h in watch["handles"]:
            h.remove()
    adam_rel = max(abs(g - c) / abs(c) for c, g in adam)
    out = {"pairs": 48, "loss_cpu": lc, "loss_card": lg,
           "loss_rel": abs(lg - lc) / abs(lc),
           "grad_max_rel": max(grad_rel.values()),
           "grad_worst": max(grad_rel, key=grad_rel.get),
           "key_bias_max_abs": key_abs,
           "sgd_loss_rel": abs(float(sgd[dev]) - float(sgd["cpu"])) /
           abs(float(sgd["cpu"])),
           "sgd_param_max_abs": sgd_abs, "adamw_losses": adam,
           "adamw_loss_max_rel": adam_rel,
           "tf32_forward_calls": len(watch["forward"]),
           "tf32_backward_calls": len(watch["backward"]),
           "tf32_seen_on": any(watch["forward"] + watch["backward"])}
    log(f"training f32 parity (card vs CPU): {out}")
    if not (out["loss_rel"] <= TRAIN_LOSS_RTOL and
            out["grad_max_rel"] <= GRAD_F32_REL and
            key_abs <= KEY_BIAS_ATOL and
            out["sgd_loss_rel"] <= TRAIN_LOSS_RTOL and
            sgd_abs <= SGD_ATOL and adam_rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"training f32: the card's step departs from "
                             f"the CPU's: {out}")
    if out["tf32_seen_on"] or not watch["forward"] or \
            len(watch["backward"]) != len(watch["forward"]) or not tf32_after:
        raise AssertionError(f"training f32: TF32 on in a step, or the "
                             f"caller's setting lost: {out}")
    return out


def train_full_width(dev) -> dict:
    """(2) The full-width preln encoder (bf16 compute) on a batch of 16
    pairs: the card's loss and per-tensor gradient cosine against the
    CPU's f32 run with the same seeded weights.  The tolerances come from
    the CPU alone: twice its own bf16 run's distance from its f32 run
    (the loss; the worst tensor's 1 - cosine), floored at the CPU test's
    bf16 bounds (1e-3 relative, 0.99).  The key third of attn.qkv.bias is
    left out of the cosines."""
    from syzgydb_tpu_torch.models.embedder import EmbedderConfig, TextEmbedder

    run = {}
    for dt, where in (("float32", "cpu"), ("bfloat16", "cpu"),
                      ("bfloat16", dev)):
        emb = TextEmbedder(EmbedderConfig(dtype=dt), seed=11, device=where)
        batch = train_batch(emb.tokenizer, 41, 16)
        run[dt, str(where)] = named_grads(emb.train_model(), batch)
    key = key_third(emb.cfg)

    def worst(grads, want):
        out = 0.0
        for k, w in want.items():
            g = grads[k]
            if k.endswith("attn.qkv.bias"):
                g, w = np.delete(g, np.r_[key]), np.delete(w, np.r_[key])
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            out = max(out, 1.0 - float(cos))
        return out

    (l32, g32), (lc16, gc16) = run["float32", "cpu"], run["bfloat16", "cpu"]
    lg16, gg16 = run["bfloat16", str(dev)]
    out = {"pairs": 16, "loss_f32_cpu": l32, "loss_bf16_cpu": lc16,
           "loss_bf16_card": lg16,
           "loss_tol": max(2 * abs(lc16 - l32), LOSS_BF16_RTOL * abs(l32)),
           "cpu_bf16_worst_1_minus_cos": worst(gc16, g32),
           "card_bf16_worst_1_minus_cos": worst(gg16, g32)}
    out["cos_tol"] = max(2 * out["cpu_bf16_worst_1_minus_cos"],
                         1 - GRAD_BF16_COS)
    log(f"training full width bf16 (card vs CPU f32): {out}")
    finite = all(np.isfinite(g).all() for g in gg16.values())
    if not finite or abs(lg16 - l32) > out["loss_tol"] or \
            out["card_bf16_worst_1_minus_cos"] > out["cos_tol"]:
        raise AssertionError(f"training full width: the card's bf16 step "
                             f"is outside its tolerance: {out}")
    return out


def train_main(dev) -> dict:
    """(3) `python -m syzgydb_tpu_torch.models.train_synthetic` as a user
    runs it (TRAIN_STEPS AdamW steps of 48 pairs on the card), its
    checkpoint written to a temporary directory: it must exit 0 (the 0.9
    gate), and the checkpoint must clear the gate again when loaded on the
    card and on the CPU."""
    from syzgydb_tpu_torch.models import train_synthetic as ts
    from syzgydb_tpu_torch.models.embedder import TextEmbedder

    folder = tempfile.mkdtemp(prefix="syzgy_train_")
    try:
        ckpt = os.path.join(folder, "trained.ckpt")
        cmd = [sys.executable, "-m",
               "syzgydb_tpu_torch.models.train_synthetic", "--out", ckpt,
               "--steps", str(TRAIN_STEPS), "--platform", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        log(f"--- train_synthetic (rc {proc.returncode}, {wall:.1f} s) ---\n"
            f"{proc.stderr[-3000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"train_synthetic exited {proc.returncode}")
        m = [ln for ln in proc.stderr.splitlines() if "accuracy:" in ln]
        out = {"steps": TRAIN_STEPS, "wall_s": wall,
               "gate_main": float(m[-1].rsplit(":", 1)[1]),
               "losses": [ln for ln in proc.stderr.splitlines()
                          if ln.startswith("step ")]}
        out["gate_card"] = ts.retrieval_accuracy(
            TextEmbedder.from_checkpoint(ckpt, device=dev))
        out["gate_cpu"] = ts.retrieval_accuracy(
            TextEmbedder.from_checkpoint(ckpt, device="cpu"))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    log(f"train_synthetic on the card: {out}")
    if min(out["gate_main"], out["gate_card"], out["gate_cpu"]) < 0.9:
        raise AssertionError(f"train_synthetic: gate below 0.9: {out}")
    return out


def train_ops(cfg, pairs: int) -> float:
    """A training step's operations: the forward's over the 2 * pairs
    texts, and twice that for the backward."""
    return 3.0 * forward_ops(cfg, 2 * pairs)


def train_step_times(emb, dev, pairs: int, rate: float, reps: int) -> dict:
    """One shape's step on the card: forward and backward (CUDA events)
    beside the operations' bound at `rate` (the masters read and the
    gradients written in f32 beside it), the AdamW step apart (CUDA
    events) beside its bytes (p, g, m and v read and written in f32: 32
    bytes a parameter), the whole step on the host clock, pairs/s, and
    device memory: the peak over the steps and how far it rose above what
    was allocated before them (weights and optimizer state included in
    the first, and whatever else the process holds)."""
    from syzgydb_tpu_torch.models import embedder as te
    from syzgydb_tpu_torch.ops.distance import full_f32

    model = emb.train_model()
    n_params = sum(p.numel() for p in model.parameters())
    batch = tuple(torch.as_tensor(x).to(dev) for x in
                  train_batch(emb.tokenizer, 50 + pairs, pairs))
    opt = te.make_optimizer(model.parameters(), 1e-4)

    def fwd_bwd():
        with full_f32():
            opt.zero_grad(set_to_none=True)
            te.contrastive_loss(model, *batch).backward()

    te.adamw_step(model, opt, *batch)  # warm: the optimizer's state
    fb = cuda_ms(fwd_bwd, reps)
    st = cuda_ms(opt.step, reps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    walls = wall_ms(lambda: te.adamw_step(model, opt, *batch), reps)
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    row = {"pairs": pairs, "fwd_bwd_ms": fb, "adamw_ms": st,
           "step_wall_ms": wall, "pairs_per_s": pairs / wall * 1e3,
           "peak_mem_mb": peak / 1e6, "step_mem_mb": (peak - before) / 1e6,
           "n_params": n_params,
           "gflop": train_ops(emb.cfg, pairs) / 1e9}
    fwd = bound(train_ops(emb.cfg, pairs), 8 * n_params, rate)
    row.update(fwd_bwd_bound_ms=fwd["bound_ms"], fwd_bwd_bound_by=fwd[
        "bound_by"], adamw_bound_ms=32 * n_params / HBM_BYTES_S * 1e3,
        adamw_bound_by="bytes")
    log(f"train step {emb.cfg.dtype} pairs {pairs}: {row}")
    return row


def train_times(dev) -> dict:
    """(4) Step times: training_config() (f32) at 48 pairs over the fp32
    rate; the full-width preln encoder (bf16) at 16, 64 and 256 pairs over
    the bf16 tensor rate; then torch.profiler over one 256-pair step:
    kernel time by name and the elementwise kernels' share."""
    from syzgydb_tpu_torch.models import embedder as te
    from syzgydb_tpu_torch.models import train_synthetic as ts

    small = te.TextEmbedder(ts.training_config(), seed=0, device=dev)
    out = {"training_config": train_step_times(small, dev, 48, FP32_FLOPS,
                                               20)}
    emb = te.TextEmbedder(te.EmbedderConfig(), seed=0, device=dev)
    out["full_width"] = {b: train_step_times(emb, dev, b, BF16_FLOPS,
                                             20 if b < 256 else 5)
                         for b in TRAIN_BATCHES}
    model = emb.train_model()
    opt = te.make_optimizer(model.parameters(), 1e-4)
    batch = tuple(torch.as_tensor(x).to(dev) for x in
                  train_batch(emb.tokenizer, 70, max(TRAIN_BATCHES)))
    out["profile"] = profile_batches(None, [
        (f"train_step_{max(TRAIN_BATCHES)}",
         lambda: te.adamw_step(model, opt, *batch))])
    return out


def training_phase(dev, card: str, report: dict) -> None:
    """Phase 6: the embedder's training on the card (train_f32_parity,
    train_full_width, train_main, train_times).  The path has no kernel of
    the port: the launch counters are reset before it and read after."""
    t0 = time.perf_counter()
    reset_counters()
    out = {"card": card, "f32_parity": train_f32_parity(dev),
           "full_width_bf16": train_full_width(dev),
           "main": train_main(dev), "times": train_times(dev)}
    out["launches"] = counters()
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"training": out}), flush=True)
    report["training"] = out


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
    for lib, ptxas in cuda_build.build_all().items():
        log(f"--- nvcc {lib} ---\n{ptxas}")
    # the JSON field projector (g++) too, so the first filter mask is
    # timed without its build; without g++ filters parse in Python
    report["jsonproj_native"] = native.get_jsonproj() is not None
    report["build_s"] = time.perf_counter() - t0
    log(f"kernels built in {report['build_s']:.1f} s")

    errs = check_kernels(dev)
    coll, tmp, state, tq, launches, rows64 = main_path(dev, report)
    mesh_phase(coll, tq, rows64, dev, card, report)
    serving(coll, tmp, tq.cpu().numpy(), rows64[:FLOW_ROWS], dev, report)
    e64 = e2e_64bit(rows64, tq.cpu().numpy(), dev, report)
    rows_text = rows64[:TEXT_ROWS].copy()
    del rows64
    times = kernel_times(coll, state, tq, dev)
    times["fp32_widths"] = fp32_width_times(tq, dev)
    times["i8_16bit"] = hilo_times(tq, dev)
    times["segmin_filtered"] = filtered_k1_times(dev)
    report["kernel_times"] = times
    tools_phase(coll, rows_text, tq.cpu().numpy(), dev, card, report)
    del rows_text
    coll.close()
    shutil.rmtree(tmp, ignore_errors=True)
    embedder_phase(dev, report)
    training_phase(dev, card, report)
    report["total_s"] = time.perf_counter() - t_start
    print(json.dumps(report), flush=True)

    seg, ham = times["segmin_q1024"], times["hamming_q8"]
    ham8, surf = times["hamming_u8_q64"], times["surface_q128"]
    free = times["segmin_seg64_q1024"]
    fp32 = times["fp32_widths"]
    seg32, surf32 = fp32["segmin_64bit_q64"], fp32["surface_64bit_q16"]
    chk32 = fp32["checks"].values()
    hilo = times["i8_16bit"]
    hilo1024 = hilo[f"segmin_i8_16bit_d{DIMS}_q1024"]

    def row(name, source, replaces, launched, err, t, library):
        return {"name": name, "route": "cuda",
                "source": f"syzgydb_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library}

    free_err = max(errs["free_seg"], times["segmin_free_max_abs_err"])
    kernels = [
        # K1 on the main path (8-bit codes, seg 32) is the int8 route; its
        # error includes the filtered cell's launch (filtered_k1_times)
        row("segmin", "segmin_i8.cu", "syzgydb_tpu/ops/pallas_scan.py:416",
            launches["segmin_i8"],
            max(errs["segmin"], times["segmin_max_abs_err"],
                times["segmin_filtered"]["max_abs_err"]), seg,
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
        # K1 int8, 16-bit: launches (scan.i8_hilo_launches over its phase)
        # and errors from its own phase (the main path is 8-bit), time at
        # 1M x 384, Q = 1024, yardstick fp32 torch.matmul (the fp32
        # kernel's time is fp32_kernel_ms in the report)
        row("segmin_i8_16bit", "segmin_i8.cu",
            "syzgydb_tpu/ops/pallas_scan.py:416", hilo["launches"],
            hilo["max_abs_err"], hilo1024, hilo1024["library_fp32_ms"]),
        # K1 and K4 on f32 codes (the REST server's default quantization,
        # 64): launches and errors from the 64-bit phase (with every tile's
        # check at every width), times at 1M x 384, the table's bound (the
        # fp32 FMA rate's is fp32_fma_bound_ms in the report), yardstick
        # fp32 torch.matmul
        row("segmin_fp32", "segmin.cu", "syzgydb_tpu/ops/pallas_scan.py:416",
            e64["launches"]["segmin_fp32"],
            max([e64["max_abs_err"]["segmin_fp32"]] +
                [c["segmin_err"] for c in chk32]), seg32,
            seg32["library_fp32_ms"]),
        row("surface_fp32", "surface.cu",
            "syzgydb_tpu/ops/pallas_scan.py:272",
            e64["launches"]["surface_fp32"],
            max([e64["max_abs_err"]["surface_fp32"]] +
                [c["surface_err"] for c in chk32]), surf32,
            surf32["library_fp32_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

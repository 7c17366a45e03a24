"""Sharded search over a device mesh (the counterpart of
``syzgydb_tpu/parallel/search.py``).

Vectors are split along N over the mesh's "data" axis and optionally along
D over "feature" (parallel/mesh.py: ``place``).  Each data shard computes
distances for its rows, keeps a local top-k, and the per-shard winners are
moved to the mesh's lead device and merged by a final top-k.  The JAX
package's collectives become explicit copies: its all-gather of the
winners is ``.to(lead)`` and ``torch.cat``, and its feature-axis psum of
partial dots is the partials moved to the data row's first device and
summed there.  Each shard's work is launched under its own device, without
a host synchronisation, so shards on different cards overlap.

At feature == 1 every shard runs the port's own kernels and their flags:
``ops/scan.fused_scan_topk`` (K1) for k <= 128, ``ops/scan.surface_topk``
(K4) past it, and ``index/hamming.hamming_candidates`` (K2) with
``rerank_topk`` for the sketch route.  At feature > 1 the partial dots are
fp32 ``torch.matmul`` products of decoded codes with TF32 off (the JAX
package computes this branch in XLA, outside Pallas).

No counterpart, because they are TPU layouts (the port keeps the outputs,
not the layouts): ``sharded_lane_slab`` / ``lane_ok_mesh``,
``sharded_ilv_codes`` / ``ilv_ok_mesh``, and the ``slab``, ``ilv``,
``use_kernel`` and ``kernel_interpret`` arguments.  The port's surfaces are
f32 at every route, so the JAX ``exact`` argument has none either.

Sharded arguments are those ``mesh.place`` returns: codes as
[data][feature] blocks, norms, valid and hashes as [data] row blocks, each
on its shard's device; queries and query sketches on any device.
"""

from __future__ import annotations

import contextlib

import torch

from ..index import hamming
from ..ops import distance as dist_ops
from ..ops import quantize as qz
from ..ops import scan
from .mesh import DATA_AXIS, FEATURE_AXIS, Mesh, col_range, sum_on

_SEG = scan.DEFAULT_SEG
# starting tie margin on a mesh (extra segments kept for value ties): the
# JAX package's 8, kept like every other TPU-tuned constant until a
# multi-GPU run measures its own
DEFAULT_MESH_SEG_MARGIN = 8


def fused_ok(k: int, n_local: int) -> bool:
    """Whether sharded_exact_topk takes the fused branch: k within the
    fused scan's serving bound and whole 32-row segments on every shard."""
    return k <= scan.MAX_FUSED_K and n_local % _SEG == 0


def _on(dev: torch.device):
    """Launch under `dev`: a kernel launches on the current CUDA device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _check_packed4(mesh: Mesh, queries, bits: int) -> None:
    """Packed 4-bit codes split on the feature axis only when every shard
    holds an even (nibble-aligned) slice of the dimension axis."""
    if bits != 4:
        return
    f = mesh.shape[FEATURE_AXIS]
    if f > 1 and (queries.shape[1] % (2 * f)) != 0:
        raise ValueError(
            f"4-bit feature sharding needs dim % (2*feature) == 0 "
            f"(dim={queries.shape[1]}, feature={f})")


def _merge_topk(mesh: Mesh, vals: list, rows: list, k: int):
    """Per-shard winners (Q, k_i) -> the global top-k on the lead device,
    ties ordered by row."""
    lead = mesh.lead
    v = torch.cat([x.to(lead) for x in vals], dim=1)
    r = torch.cat([x.to(lead) for x in rows], dim=1)
    return dist_ops.sort_topk(v, r, min(k, v.shape[1]))


class _Row:
    """One data row's feature shards of the queries, with the psum'd query
    terms (Q, 1) on the row's first device."""

    def __init__(self, mesh: Mesh, i: int, queries):
        self.dev = mesh.devices[i, 0]
        self.devs = list(mesh.devices[i])
        d = queries.shape[1]
        self.qs = [queries[:, slice(*col_range(mesh, d, j))].to(
            dv, torch.float32) for j, dv in enumerate(self.devs)]
        self.qn2 = sum_on([q.square().sum(dim=-1, keepdim=True)
                           for q in self.qs], self.dev)
        self.qsum = sum_on([q.sum(dim=-1, keepdim=True) for q in self.qs],
                           self.dev)

    def dots(self, raws: list, bits: int):
        """Summed raw contractions -> true dots (affine dequantization
        after the psum, as the JAX package applies it)."""
        raw = sum_on(raws, self.dev)
        if bits in (32, 64):
            return raw
        scale, offset = qz.affine_constants(bits)
        return scale * raw + offset * self.qsum

    def surface_dots(self, blocks: list, bits: int):
        """(Q, n_local) dots of every row, from each feature block's fp32
        product of its decoded codes."""
        raws = []
        for q, c, dv in zip(self.qs, blocks, self.devs):
            with _on(dv), dist_ops.full_f32():
                raws.append(q @ dist_ops.decode_codes(c, bits,
                                                      q.shape[1]).T)
        return self.dots(raws, bits)

    def candidate_dots(self, blocks: list, cand, bits: int):
        """(Q, C) dots of each query's candidate rows `cand` (Q, C), the
        candidates' codes gathered on each feature shard."""
        raws = []
        for q, c, dv in zip(self.qs, blocks, self.devs):
            with _on(dv):
                idx = cand.to(dv)
                cc = c.index_select(0, idx.reshape(-1)).reshape(
                    tuple(idx.shape) + tuple(c.shape[1:]))
                vals = dist_ops.decode_codes(cc, bits, q.shape[1])
                with dist_ops.full_f32():
                    raws.append(torch.einsum("qd,qcd->qc", q, vals))
        return self.dots(raws, bits)


def _tp_segmin_topk(row: _Row, blocks, nrm, v, *, bits: int, metric: str,
                    k: int, seg_margin: int, dims: int):
    """One data shard's fused top-k under feature sharding: the summed
    surface's segment minima, then ops/scan.select_segments with a rerank
    of the candidates' summed partial dots.  The flag's delta is
    surface_delta at the FULL dimension (accumulation and psum span every
    feature shard), with no query-rounding term: the surface is fp32."""
    nq = row.qs[0].shape[0]
    n_local = nrm.shape[0]
    nseg = n_local // _SEG
    surr = scan.surrogate(row.qn2, row.surface_dots(blocks, bits), nrm, v,
                          metric)
    segmins = surr.reshape(nq, nseg, _SEG).amin(dim=-1)
    del surr
    s = min(k + seg_margin, nseg)
    delta = scan.surface_delta(row.qn2[:, 0], nrm, v, metric=metric,
                               dims=dims)

    def rerank(seg_idx):
        rows = (seg_idx[:, :, None] * _SEG + torch.arange(
            _SEG, device=row.dev)[None, None, :]).reshape(nq, -1)
        dots = row.candidate_dots(blocks, rows, bits)
        return scan.dist_surr(
            row.qn2, dots, scan.gather_segments(nrm, seg_idx, _SEG),
            scan.gather_segments(v, seg_idx, _SEG), metric)

    return scan.select_segments(segmins, delta, rerank, qn2=row.qn2[:, 0],
                                metric=metric, k=k, seg=_SEG, s=s,
                                with_ties=True)


def _tp_distances(row: _Row, blocks, nrm, v, *, bits: int, metric: str):
    """(Q, n_local) f32 distances of one data shard under feature
    sharding, invalid rows +inf."""
    dots = row.surface_dots(blocks, bits)
    return scan.dist_surr(row.qn2, dots, nrm[None, :], v[None, :],
                          metric)[0]


def sharded_exact_topk(mesh: Mesh, queries, codes, norms, valid, *,
                       bits: int, metric: str, k: int,
                       seg_margin: int = DEFAULT_MESH_SEG_MARGIN,
                       with_ties: bool = False):
    """Exhaustive sharded scan -> (dist (Q, k), global rows (Q, k)
    [, ok (Q,) int32 with_ties]), on the mesh's lead device, ties ordered
    by row.

    Fused branch (fused_ok(k, n_local)): at feature == 1 each data shard
    runs ops/scan.fused_scan_topk on its rows (K1, then the fp32 rerank and
    the flag with that route's dq_rel) at tie margin `seg_margin`; at
    feature > 1 the summed-partials surface (_tp_segmin_topk).  Otherwise
    each shard selects its top k from the whole surface: at feature == 1
    ops/scan.surface_topk over K4 at a margin of seg_margin * 32 rows,
    whose flag proves the cut; at feature > 1 an exact top-k of the f32
    distances (flag 1).  ok is the AND of the shards' flags: where it is 0
    the caller escalates seg_margin."""
    _check_packed4(mesh, queries, bits)
    n_local = norms[0].shape[0]
    fused = fused_ok(k, n_local)
    f = mesh.shape[FEATURE_AXIS]
    dims = queries.shape[1]
    vals, rows, oks = [], [], []
    for i in range(mesh.shape[DATA_AXIS]):
        dev = mesh.devices[i, 0]
        with _on(dev):
            if f == 1:
                q = queries.to(dev, torch.float32)
                if fused:
                    d, r, ok = scan.fused_scan_topk(
                        q, codes[i][0], norms[i], valid[i], bits=bits,
                        metric=metric, k=k, tie_margin=seg_margin,
                        with_ties=True)
                else:
                    d, r, ok = scan.surface_topk(
                        q, codes[i][0], norms[i], valid[i], bits=bits,
                        metric=metric, k=k,
                        margin=min(seg_margin * _SEG, n_local))
            else:
                row = _Row(mesh, i, queries)
                if fused:
                    d, r, ok = _tp_segmin_topk(
                        row, codes[i], norms[i], valid[i], bits=bits,
                        metric=metric, k=k, seg_margin=seg_margin, dims=dims)
                else:
                    dist = _tp_distances(row, codes[i], norms[i], valid[i],
                                         bits=bits, metric=metric)
                    d, r = dist_ops.sort_topk(
                        dist, torch.arange(n_local, device=dev).expand_as(
                            dist), min(k, n_local))
                    ok = torch.ones((d.shape[0],), dtype=torch.int32,
                                    device=dev)
        vals.append(d)
        rows.append(r + i * n_local)
        oks.append(ok)
    dist, rows = _merge_topk(mesh, vals, rows, k)
    if not with_ties:
        return dist, rows
    ok = torch.stack([x.to(mesh.lead) for x in oks]).amin(dim=0)
    return dist, rows, ok  # complete iff EVERY shard is


def sharded_scores(mesh: Mesh, queries, codes, norms, valid, *, bits: int,
                   metric: str):
    """The full (Q, N) f32 distance matrix on the lead device (fp32
    products of decoded codes, partials summed over feature shards)."""
    _check_packed4(mesh, queries, bits)
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        row = _Row(mesh, i, queries)
        with _on(row.dev):
            out.append(_tp_distances(row, codes[i], norms[i], valid[i],
                                     bits=bits, metric=metric))
    return torch.cat([x.to(mesh.lead) for x in out], dim=1)


def sharded_ann_topk(mesh: Mesh, qcodes, queries, codes, norms, hashes,
                     valid, *, bits: int, metric: str, k: int,
                     local_budget: int, with_counts: bool = False):
    """Sharded sketch prefilter + rerank -> (dist (Q, k), rows (Q, k)
    [, nscored (Q,) int32]) on the lead device.

    Each data shard ranks its rows by the Hamming distance of the packed
    sketches (index/hamming.hamming_candidates: K2 on the card), takes its
    min(local_budget, n_local) best exactly (torch.topk), reranks them in
    fp32 (index/hamming.rerank_topk; at feature > 1 from the candidates'
    summed partial dots) and keeps its top k; the winners are merged.  The
    total candidate budget is local_budget * data shards; nscored counts
    the valid candidates scored across the shards."""
    _check_packed4(mesh, queries, bits)
    f = mesh.shape[FEATURE_AXIS]
    vals, rows, counts = [], [], []
    for i in range(mesh.shape[DATA_AXIS]):
        dev = mesh.devices[i, 0]
        n_local = norms[i].shape[0]
        with _on(dev):
            _, cand = hamming.hamming_candidates(
                qcodes.to(dev), hashes[i], valid[i],
                min(local_budget, n_local))
            if f == 1:
                d, r, nsc = hamming.rerank_topk(
                    queries.to(dev, torch.float32), codes[i][0], norms[i],
                    valid[i], cand, bits, metric, k, with_counts=True)
            else:
                row = _Row(mesh, i, queries)
                dots = row.candidate_dots(codes[i], cand, bits)
                cvalid = valid[i][cand]
                dist, _ = scan.dist_surr(row.qn2, dots, norms[i][cand],
                                         cvalid, metric)
                d, r = dist_ops.sort_topk(dist, cand, min(k, cand.shape[1]))
                nsc = cvalid.sum(dim=1).to(torch.int32)
        vals.append(d)
        rows.append(r + i * n_local)
        counts.append(nsc)
    dist, rows = _merge_topk(mesh, vals, rows, k)
    if with_counts:
        return dist, rows, torch.stack(
            [c.to(mesh.lead) for c in counts]).sum(dim=0).to(torch.int32)
    return dist, rows

"""Exact distances over the stored rows, in plain PyTorch.

The reference quantizes the benchmark's own float rows with its frozen
codec (codec.py) and computes float64 distances on whatever device it is
given, in blocks of queries.  It imports nothing of the program.

Distances follow SyzgyDB (collection.go:812-832):
    euclidean(a, b) = sqrt(sum((a - b)^2))
    cosine(a, b)    = acos(a.b / (|a| |b|)) / pi, 1.0 where either is zero

A control, a lower precision put in the program's place, is the same
class with fewer code bits, or with rows and queries rounded to bfloat16
and summed in float32 (`rounding=torch.bfloat16`).
"""

from __future__ import annotations

import math

import torch

from . import codec

# bytes of distances one query block may hold
BLOCK_BYTES = 2 << 30


class Reference:
    def __init__(self, rows: torch.Tensor, *, bits: int, metric: str,
                 rounding: torch.dtype = torch.float64):
        if metric not in ("cosine", "euclidean"):
            raise ValueError(f"unknown metric {metric!r}")
        self.bits, self.metric, self.rounding = bits, metric, rounding
        self.acc = torch.float64 if rounding == torch.float64 \
            else torch.float32
        codes = codec.quantize(rows, bits)
        self.codes = codes.to(torch.uint8 if bits <= 8 else torch.int32).cpu()
        self.n, self.dims = self.codes.shape
        self._vecs = None
        self._sq = None

    # -- device state --------------------------------------------------

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.rounding).to(self.acc)

    def vectors(self, device) -> torch.Tensor:
        """(N, D) dequantized rows, rounded, on `device`."""
        device = torch.device(device)
        if self._vecs is None or self._vecs.device != device:
            self.release()
            step = 1 << 17
            out = torch.empty((self.n, self.dims), dtype=self.acc,
                              device=device)
            for a in range(0, self.n, step):
                block = self.codes[a:a + step].to(device)
                out[a:a + step] = self._round(codec.dequantize(block,
                                                               self.bits))
            self._vecs = out
            self._sq = out.square().sum(dim=1).to(torch.float64)
        return self._vecs

    def release(self) -> None:
        self._vecs = self._sq = None

    def stored(self, ids) -> torch.Tensor:
        """float64 values of the given rows, as the codec decodes them."""
        idx = torch.as_tensor(ids, dtype=torch.int64)
        return codec.dequantize(self.codes[idx], self.bits)

    # -- distances -----------------------------------------------------

    def _from_dots(self, dots, q_sq, v_sq):
        """Distances from dots and squared norms (broadcasting), float64."""
        dots = dots.to(torch.float64)
        if self.metric == "euclidean":
            return (q_sq - 2.0 * dots + v_sq).clamp_(min=0.0).sqrt_()
        denom = (q_sq * v_sq).sqrt()
        ok = denom > 0
        cos = dots / torch.where(ok, denom, torch.ones_like(denom))
        dist = torch.acos(cos.clamp(-1.0, 1.0)) / math.pi
        return torch.where(ok, dist, torch.ones_like(dist))

    def topk(self, queries, m: int, device):
        """The m nearest rows of each query, ascending ->
        (dist (Q, m) float64, rows (Q, m) int64), both on the CPU.
        Ties are ordered by row."""
        v = self.vectors(device)
        q_all = self._round(torch.as_tensor(queries).to(device,
                                                        torch.float64))
        m = min(m, self.n)
        step = max(1, BLOCK_BYTES // (8 * self.n))
        dists, rows = [], []
        for a in range(0, q_all.shape[0], step):
            q = q_all[a:a + step]
            q_sq = q.square().sum(dim=1, keepdim=True).to(torch.float64)
            d = self._from_dots(q @ v.T, q_sq, self._sq[None, :])
            top = torch.topk(d, m, dim=1, largest=False, sorted=True)
            del d
            rows.append(top.indices.cpu())
            # the chosen rows' distances by the direct formula
            dists.append(self.pairs(q, top.indices, device).cpu())
        dist, row = torch.cat(dists), torch.cat(rows)
        order = torch.argsort(row, dim=1, stable=True)
        dist, row = dist.gather(1, order), row.gather(1, order)
        order = torch.argsort(dist, dim=1, stable=True)
        return dist.gather(1, order), row.gather(1, order)

    def pairs(self, queries, rows, device) -> torch.Tensor:
        """(Q, M) float64 distances of each query to its own rows; a row
        of -1 (nothing returned) reads +inf.  On `device`, in blocks of
        queries."""
        q_all = torch.as_tensor(queries)
        r_all = torch.as_tensor(rows)
        width = max(1, r_all.shape[1]) * self.dims * 8
        step = max(1, BLOCK_BYTES // 4 // width)
        return torch.cat([self._pairs(q_all[a:a + step], r_all[a:a + step],
                                      device)
                          for a in range(0, q_all.shape[0], step)])

    def _pairs(self, queries, rows, device) -> torch.Tensor:
        v = self.vectors(device)
        q = self._round(queries.to(device, torch.float64))
        r = rows.to(device, torch.int64)
        missing = r < 0
        safe = r.clamp(min=0)
        g = v[safe]                                 # (Q, M, D)
        if self.metric == "euclidean":
            d = (g - q[:, None, :]).square().sum(dim=2).sqrt()
            d = d.to(torch.float64)
        else:
            d = self._from_dots(
                (g * q[:, None, :]).sum(dim=2),
                q.square().sum(dim=1, keepdim=True).to(torch.float64),
                self._sq[safe])
        return d.masked_fill(missing, math.inf)

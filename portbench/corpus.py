"""The benchmark's data, made on the device.

Rows are clustered unit vectors, the shape of text-embedding corpora:
`centers` random unit centres, each row a centre plus a random unit
direction scaled by `spread`, normalised.  Queries are stored rows plus
`noise` times a random unit direction, normalised, drawn into a pool.
Rows and pool come from the configuration's own data `seed`, the same in
every run, as a public benchmark's data set and query set are: every run
does the same work.  The run's --seed draws the order in which the pool
is sent and the calls that are judged.
"""

from __future__ import annotations

import numpy as np
import torch


def seed64(seed: int) -> int:
    """Any whole number as the 64-bit seed that generators take."""
    return int(seed) % (1 << 64)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x.div_(x.norm(dim=1, keepdim=True))


def make_rows(gen: dict, n: int, dims: int, device):
    """(rows (n, dims) float32 on `device`, the generator that goes on to
    make the pool)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed64(gen["seed"]))
    centers = _unit(torch.randn(gen["centers"], dims, generator=g,
                                device=device))
    assign = torch.randint(0, gen["centers"], (n,), generator=g,
                           device=device)
    rows = _unit(torch.randn(n, dims, generator=g, device=device))
    rows.mul_(gen["spread"]).add_(centers[assign])
    del centers, assign
    _unit(rows)
    return rows, g


def make_queries(rows: torch.Tensor, g: torch.Generator, pool: int,
                 noise: float) -> torch.Tensor:
    """(pool, dims) float32: stored rows plus `noise`, normalised."""
    src = torch.randint(0, rows.shape[0], (pool,), generator=g,
                        device=rows.device)
    q = _unit(torch.randn(pool, rows.shape[1], generator=g,
                          device=rows.device))
    return _unit(q.mul_(noise).add_(rows[src]))


class Order:
    """Which pool queries each call sends: the pool in a seeded order,
    pass after pass, `batch` queries a call."""

    def __init__(self, pool: int, batch: int, seed: int):
        if pool % batch:
            raise ValueError(f"pool {pool} is not a multiple of batch {batch}")
        self.pool, self.batch = pool, batch
        self._rng = np.random.default_rng([seed64(seed), 0x6f72646572])
        self._perm: list[np.ndarray] = []

    def __call__(self, call: int) -> np.ndarray:
        a = call * self.batch
        p, off = divmod(a, self.pool)
        while len(self._perm) <= p:
            self._perm.append(self._rng.permutation(self.pool))
        return self._perm[p][off:off + self.batch]

"""Device mesh and row/column splits — the port's multi-device layer
(the counterpart of ``syzgydb_tpu/parallel/mesh.py``).

The vector axis N is split over the mesh's "data" axis and, optionally, the
dimension axis D over its "feature" axis.  The JAX package drives its mesh
from one process through ``jax.shard_map``; the port does the same with one
Python process and a (data, feature) grid of ``torch.device``s: each shard's
tensors live on its device, each shard's work is launched there
(asynchronously, so shards on different cards overlap), and the collectives
become explicit copies (parallel/search.py).  No ``torch.distributed``
process group is involved.

A device may appear more than once in the grid: a mesh of
``[torch.device("cuda", 0)] * 4`` runs every sharding path, with its
kernels on every shard, on one card, the shards one after another.  A grid
of ``[torch.device("cpu")] * 8`` is the CPU tests' mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 0      # 0 = all devices on the data axis
    feature: int = 1   # feature-axis (D) sharding degree


class Mesh:
    """A (data, feature) grid of torch devices.  `shape` maps each axis
    name to its size, as a JAX mesh's does; `lead` is devices[0, 0], where
    sharded results are merged."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (data, feature) grid")
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0],
                      FEATURE_AXIS: devices.shape[1]}

    @property
    def lead(self) -> torch.device:
        return self.devices[0, 0]

    def row_devices(self) -> list:
        """The first device of each data row: where a data shard's norms,
        validity and sketches live and its feature partials are summed."""
        return list(self.devices[:, 0])


def visible_devices() -> list:
    """Every CUDA device of this process (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        # a kernel launches on the current device: every shard names its own
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
    return d


def make_mesh(config: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """A data x feature mesh over `devices` (default: every CUDA device;
    raises when there is none, never falling back to the CPU).  A device
    may repeat: the shards it holds then run on it one after another."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError(
                "make_mesh() needs CUDA devices and torch.cuda.is_available()"
                " is False; pass devices=[torch.device('cpu')] * n for a CPU "
                "mesh")
    devices = [_device(d) for d in devices]
    n = len(devices)
    feature = max(1, config.feature)
    data = config.data if config.data > 0 else n // feature
    # data >= 1 guard: feature > n would give data = 0 and an empty mesh
    if data < 1 or data * feature > n:
        raise ValueError(
            f"mesh {data}x{feature} needs {max(data, 1) * feature} devices,"
            f" have {n}")
    grid = np.empty((data, feature), dtype=object)
    for i, d in enumerate(devices[: data * feature]):
        grid[i // feature, i % feature] = d
    return Mesh(grid)


def pad_rows(n: int, mesh: Mesh, block: int = 8) -> int:
    """Round n up so each data shard holds a whole multiple of `block` rows."""
    shards = mesh.shape[DATA_AXIS]
    per = -(-n // shards)
    per = -(-per // block) * block
    return per * shards


def pad_cols(d: int, mesh: Mesh) -> int:
    shards = mesh.shape[FEATURE_AXIS]
    return -(-d // shards) * shards


def col_range(mesh: Mesh, width: int, j: int) -> tuple[int, int]:
    """Columns [a, b) of feature shard j of a `width`-column array (the
    counterpart of the D half of row_sharding); width must divide."""
    f = mesh.shape[FEATURE_AXIS]
    if width % f:
        raise ValueError(f"{width} columns do not split over {f} feature "
                         f"shards")
    step = width // f
    return j * step, (j + 1) * step


def sum_on(parts: list, dev: torch.device):
    """The feature-axis psum: partials moved to `dev` and summed in shard
    order."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def split_rows(mesh: Mesh, arr: np.ndarray, n_local: int) -> list:
    """Rows of each data shard (the counterpart of row_only_sharding): shard
    i holds rows [i * n_local, (i + 1) * n_local) of `arr`, zero-filled past
    its end (padding rows are invalid wherever validity is split alike)."""
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        part = arr[i * n_local:(i + 1) * n_local]
        if part.shape[0] < n_local:
            pad = np.zeros((n_local - part.shape[0],) + arr.shape[1:],
                           dtype=arr.dtype)
            part = np.concatenate([part, pad])
        out.append(part)
    return out


def place(mesh: Mesh, codes, norms, valid, hashes=None, *, bits: int,
          n_local: Optional[int] = None) -> dict:
    """Host columns (numpy, N rows) -> a sharded device state:

      codes:  [data][feature] blocks, rows of data shard i and columns of
              feature shard j on devices[i, j] (row_sharding);
      norms, valid[, hashes]: [data] row blocks on each data row's first
              device (row_only_sharding; sketches are not feature-split);
      n_local: rows per data shard (default: N over the data shards,
              rounded up to whole 32-row segments — pad rows are invalid).

    64-bit codes go to f32 and sketch words to int32, as
    convert.device_state_from_numpy places them."""
    from .. import convert

    n = np.asarray(valid).shape[0]
    if n_local is None:
        n_local = pad_rows(n, mesh, 32) // mesh.shape[DATA_AXIS]
    f = mesh.shape[FEATURE_AXIS]
    parts = [split_rows(mesh, np.asarray(a), n_local)
             if a is not None else None
             for a in (codes, norms, valid, hashes)]
    state = {"codes": [], "norms": [], "valid": [], "n_local": n_local}
    if hashes is not None:
        state["hashes"] = []
    for i, dev in enumerate(mesh.row_devices()):
        st = convert.device_state_from_numpy(
            parts[0][i], parts[1][i], parts[2][i],
            None if parts[3] is None else parts[3][i], bits=bits, device=dev)
        c = st["codes"]
        state["codes"].append(
            [c] if f == 1 else
            [c[:, slice(*col_range(mesh, c.shape[1], j))].contiguous().to(
                mesh.devices[i, j]) for j in range(f)])
        for name in ("norms", "valid", "hashes"):
            if name in st:
                state[name].append(st[name])
    return state

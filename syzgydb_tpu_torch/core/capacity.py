"""Capacity preflight (the port of ``syzgydb_tpu/core/capacity.py``):
predict the host-RAM and GPU-memory footprint of a prospective column
capacity and fail a create/ingest/reopen with a clean, actionable error
BEFORE an allocator runs out mid-operation.

  host   = codes + norms + ids + valid + hashes at the GROWN capacity, plus
           the live metadata estimate — checked against /proc/meminfo
           MemAvailable with a safety margin.
  device = codes + norms + valid + hashes, plus the largest search
           transient (search_transient: the fused scan's gather budget and
           the segment-min surface of a 2048-query batch, or the non-fused
           branch's K4 surface chunks and the selection beside them) —
           checked against the card's total memory
           (torch.cuda.mem_get_info) on CUDA placements and skipped on the
           CPU, where the host check covers the columns.  Under a mesh
           (Collection.use_mesh) the peak divides over the data shards, and
           each shard device is checked for the shards it holds.

The port has no lean placement and no derived code layouts (lane slab,
interleaved operand), so the estimate is one codes buffer.
"""

from __future__ import annotations

from typing import Optional

import torch

_HOST_MARGIN = 0.90
_DEVICE_MARGIN = 0.90
# the widest query batch the transient estimate budgets the (Q, N/32)
# segment-min surface for
_TRANSIENT_QUERIES = 2048


class CapacityError(MemoryError):
    """A create/ingest/reopen would exceed the host or device memory
    envelope.  Raised BEFORE any bytes are written."""


def grown_capacity(cur_cap: int, min_capacity: int) -> int:
    """THE column-store sizing policy (ColumnStore._grow delegates here):
    doubling to 4M rows, then 25% linear growth, 8192-aligned."""
    from .columns import (_GROWTH_ALIGN, _INITIAL_CAPACITY,
                          _LINEAR_GROWTH_ABOVE)
    new_cap = max(_INITIAL_CAPACITY, cur_cap)
    while new_cap < min_capacity:
        if new_cap >= _LINEAR_GROWTH_ABOVE:
            new_cap = -(-(new_cap + new_cap // 4) //
                        _GROWTH_ALIGN) * _GROWTH_ALIGN
        else:
            new_cap *= 2
    return new_cap


def host_available() -> Optional[int]:
    """MemAvailable in bytes, or None when unknowable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def device_budget(device: torch.device) -> Optional[int]:
    """Total memory of a CUDA device in bytes; None for the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def search_transient(capacity: int) -> dict:
    """The largest device transient of one search dispatch at `capacity`
    rows, by route (they never overlap, so the peak is the
    larger):

      fused:     the rerank's gather budget plus the (Q, N/32) f32
                 segment-min surface of a _TRANSIENT_QUERIES batch;
      non_fused: scan.surface_topk's query chunk — K4's f32 surface rows,
                 torch.topk's working set and the selected candidates,
                 whose codes are gathered and reranked in pieces — which
                 stays within SURFACE_BUDGET_BYTES at any kk, unless one
                 query selecting every row (28 + 64 bytes a row, plus its
                 rerank piece) needs more: past ~35M rows, where the fused
                 surface is larger still."""
    from ..ops import scan
    fused = scan.GATHER_BUDGET_BYTES + \
        4 * _TRANSIENT_QUERIES * (capacity // scan.DEFAULT_SEG)
    non_fused = max(scan.SURFACE_BUDGET_BYTES,
                    scan.surface_query_bytes(capacity, capacity) +
                    scan.SURFACE_BUDGET_BYTES // 4)
    return {"fused": fused, "non_fused": non_fused,
            "peak": max(fused, non_fused)}


def estimate(capacity: int, code_row_bytes_host: int,
             code_row_bytes_dev: int, hash_words: int,
             meta_row_bytes: int) -> dict:
    """Byte estimates for one capacity."""
    fixed = code_row_bytes_host + 4 + 8 + 1 + 4 * hash_words
    host = capacity * (fixed + meta_row_bytes)
    dev = capacity * (code_row_bytes_dev + 4 + 1 + 4 * hash_words)
    transient = search_transient(capacity)["peak"]
    return {"host_bytes": host, "device_bytes": dev,
            "device_peak": dev + transient}


def _gib(n: int) -> str:
    return f"{n / (1 << 30):.2f} GiB"


def new_rows_needed(columns, doc_ids) -> int:
    """How many genuinely NEW rows an ingest of doc_ids allocates: ids
    already stored reuse their row, and free-list rows absorb the rest."""
    row_of = columns._row_of
    fresh = {int(i) for i in doc_ids if int(i) not in row_of}
    return max(0, len(fresh) - len(columns._free))


def preflight(collection, n_new: int, meta_bytes_new: int = 0) -> None:
    """Raise CapacityError when growing `collection` by n_new rows would
    exceed the host or device envelope.  Cheap no-op when no growth is
    needed.  Call BEFORE writing to the span log."""
    cols = collection.columns
    need = cols.size + n_new
    new_cap = grown_capacity(cols.capacity, need)
    if new_cap <= cols.capacity:
        return

    q = collection.quantization
    code_row_host = cols.codes.shape[1] * cols.codes.dtype.itemsize
    code_row_dev = cols.codes.shape[1] * (4 if q == 64
                                          else cols.codes.dtype.itemsize)
    if cols.metadata_resident:
        live_meta = sum(len(m) for m in cols.metadata if m is not None)
        n_meta = len(cols) + max(n_new, 1)
        meta_row = (live_meta + meta_bytes_new) // max(n_meta, 1)
    else:
        meta_row = 0
    dims = collection.dimension_count
    est = estimate(new_cap, code_row_host, code_row_dev, cols.hash_words,
                   meta_row)

    host_avail = host_available()
    if host_avail is not None and \
            est["host_bytes"] > host_avail * _HOST_MARGIN:
        raise CapacityError(
            f"ingest of {n_new} rows would grow collection "
            f"'{collection.options.name}' to capacity {new_cap} "
            f"({dims}-d, {q}-bit), needing ~{_gib(est['host_bytes'])} of "
            f"host RAM with only {_gib(host_avail)} available. "
            f"Nothing was written. Options: ingest in smaller batches "
            f"after removing rows, lower the quantization width, or run "
            f"on a larger-memory host.")

    mesh = collection._mesh
    if mesh is None:
        loads = {collection.device: est["device_peak"]}
    else:
        # the per-device peak divides over the data shards; a device that
        # holds several shards (a repeated mesh device) carries each
        per_shard = est["device_peak"] // mesh.shape["data"]
        loads = {}
        for dev in mesh.row_devices():
            loads[dev] = loads.get(dev, 0) + per_shard
    for dev, load in loads.items():
        budget = device_budget(dev)
        if budget is not None and load > budget * _DEVICE_MARGIN:
            where = "" if mesh is None else \
                f" on {dev} (its shards of a {mesh.shape['data']}-shard mesh)"
            raise CapacityError(
                f"ingest of {n_new} rows would grow collection "
                f"'{collection.options.name}' to capacity {new_cap} "
                f"({dims}-d, {q}-bit), placing ~{_gib(load)}{where} "
                f"(codes+norms+valid+hashes+search transient) against a "
                f"{_gib(budget)} GPU. Nothing was written. Options: shard "
                f"over more devices (use_mesh), lower the quantization "
                f"width or split into multiple collections.")

"""Collection — the core DB object of the PyTorch port.

The counterpart of ``syzgydb_tpu/core/collection.py`` with the same API
(SyzgyDB Go parity: AddDocument / GetDocument / UpdateDocument /
RemoveDocument / Search / GetAllIDs / ComputeStats / GetDocumentCount /
Close) and the same on-disk format, so either package opens the other's
collection files.  Search modes:

  * K == 0 and Radius == 0  -> paginated ID-ordered listing (lexicographic on
    the decimal ID string — reference quirk, spanfile.go:541-547)
  * precision "high"        -> exhaustive segment-min scan (kernel K1,
                               ops/scan.py) + fp32 rerank of the winning
                               segments, provably the exact f32 top-k: the
                               selection escalates its margin whenever a
                               per-query flag cannot prove completeness
  * precision "exact"       -> the same device shortlist, reranked on the
                               host in f64 (reference semantics)
  * precision "medium"      -> sketch-prefiltered scan (kernel K2,
                               index/hamming.py) for small batches; large
                               batches ride the exhaustive scan
  * Radius > 0              -> the same routes at a shared top-kk shape,
                               escalating kk (or the sketch budget) x4
                               until every query's worst returned distance
                               clears its radius; past the fused scan's k
                               bound the exhaustive route selects from
                               kernel K4's full surface (ops/scan.py
                               surface_topk)

Metadata filters are callables or query strings (query/): a string is
evaluated over columnar field projections where its shape allows
(query/columnar.py), else by a compiled closure per row, and the mask is
cached per (query, mutation generation).  A filtered device search uploads
the mask as the validity column.

Documents are durable in the span log (core/storage.py) and live columnar
in numpy arrays (core/columns.py) mirroring the device layout; searches
place the columns on the device once per mutation generation (bounded
dirty-row batches are scattered in place) and run there.

The device is a constructor argument, not an option: ``Collection(options,
device=None)`` runs on CUDA unless the caller passes ``device="cpu"``, and
raises when CUDA is asked for and absent.  ``use_mesh(mesh)`` shards the
device columns over a mesh's data axis (parallel/mesh.py): shard i holds a
contiguous block of rows on its own device, and searches run per shard and
merge on the mesh's lead device (parallel/search.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..index import hamming
from ..ops import distance as dist_ops
from ..ops import quantize as qz
from ..ops import scan
from ..utils import spans
from ..utils.locks import FairRLock
from ..utils.rng import MyRandom, my_random
from . import capacity as capacity_mod

EUCLIDEAN = 0
COSINE = 1

_METRIC_NAME = {EUCLIDEAN: "euclidean", COSINE: "cosine"}

FilterFn = Callable[[int, bytes], bool]

# Minimum live docs before the sketch index calibrates/activates; below this a
# "medium" search just scans.
MIN_INDEX_SIZE = 256
# Batch-size crossover between the sketch index and the exhaustive scan for
# precision="medium": above Q ~= N/(budget*F) medium routes to the scan
# (exact results as a bonus).  F=16 was measured on the TPU and is kept
# until the H100 gives its own crossover.
ANN_BATCH_CROSSOVER = 16
DEFAULT_SEARCH_BUDGET = 2048
# below this many stored elements (rows x dims) exhaustive searches run on
# the host in f64 — kept from the JAX package so both route alike
HOST_SCAN_MAX_ELEMS = 1 << 21

@dataclasses.dataclass
class CollectionOptions:
    """Mirrors reference CollectionOptions (collection.go:31-49); the JSON
    form is byte-compatible with the JAX package's."""
    name: str
    distance_method: int = EUCLIDEAN
    dimension_count: int = 0
    quantization: int = 64
    create_and_overwrite: bool = False
    index_tables: int = hamming.DEFAULT_TABLES
    index_bits_per_table: int = hamming.DEFAULT_BITS_PER_TABLE
    search_budget: int = DEFAULT_SEARCH_BUDGET
    index_seed: int = 0  # 0 = derive from global RNG at creation
    # out-of-core metadata: keep no metadata bytes resident — reads fetch
    # from the span log on demand
    metadata_on_demand: bool = False

    def to_json(self) -> bytes:
        return json.dumps({
            "name": os.path.basename(self.name),
            "distance_method": self.distance_method,
            "dimension_count": self.dimension_count,
            "quantization": self.quantization,
            "index_tables": self.index_tables,
            "index_bits_per_table": self.index_bits_per_table,
            "search_budget": self.search_budget,
            "index_seed": self.index_seed,
            "metadata_on_demand": self.metadata_on_demand,
        }).encode()

    @staticmethod
    def merge_from_json(opts: "CollectionOptions", raw: bytes) -> "CollectionOptions":
        """Stored options override caller options (collection.go:241-252)."""
        d = json.loads(raw)
        out = dataclasses.replace(
            opts,
            distance_method=d.get("distance_method", opts.distance_method),
            dimension_count=d.get("dimension_count", opts.dimension_count),
            quantization=d.get("quantization", opts.quantization),
        )
        for f in ("index_tables", "index_bits_per_table", "search_budget",
                  "index_seed", "metadata_on_demand"):
            if f in d:
                setattr(out, f, d[f])
        return out


@dataclasses.dataclass
class Document:
    id: int
    vector: np.ndarray
    metadata: bytes


@dataclasses.dataclass
class SearchArgs:
    vector: Optional[Sequence[float]] = None
    filter: Optional[FilterFn] = None
    filter_query: Optional[str] = None
    k: int = 0
    radius: float = 0.0
    offset: int = 0
    limit: int = 0
    precision: str = ""  # "" -> "medium" (collection.go:573-575)


@dataclasses.dataclass
class SearchResult:
    id: int
    metadata: bytes
    distance: float


@dataclasses.dataclass
class SearchResults:
    results: list[SearchResult]
    percent_searched: float
    search_time_ms: float = 0.0


@dataclasses.dataclass
class CollectionStats:
    document_count: int
    dimension_count: int
    quantization: int
    distance_method: str
    storage_size: int
    average_distance: float

    def to_dict(self) -> dict:
        return {
            "document_count": self.document_count,
            "dimension_count": self.dimension_count,
            "quantization": self.quantization,
            "distance_method": self.distance_method,
            "storage_size": self.storage_size,
            "average_distance": self.average_distance,
        }


def validate_options(options: CollectionOptions) -> None:
    """Reject invalid options BEFORE any file is created or written (stored
    options override caller options on reopen, so a persisted bad option
    would make every retry fail)."""
    if options.dimension_count <= 0:
        raise ValueError("dimension_count must be positive")
    qz._check_bits(options.quantization)
    if options.distance_method not in _METRIC_NAME:
        raise ValueError(f"invalid distance_method {options.distance_method}")
    hamming.check_index_shape(options.index_tables,
                              options.index_bits_per_table)
    if options.search_budget < 1:
        raise ValueError("search_budget must be >= 1")


def resolve_device(device=None) -> torch.device:
    """The collection's device: CUDA unless the caller asks for the CPU.
    Asking for CUDA where none is available raises — a collection never
    carries on on the CPU in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_collection_tokens = itertools.count(1)


class Collection:
    def __init__(self, options: CollectionOptions,
                 rng: Optional[MyRandom] = None, device=None):
        from .storage import SpanLog

        # process-unique identity for batch grouping: id(coll) can be reused
        # by a new collection once this one is collected, which would let a
        # stale batch key alias across collections (server/batcher.py keys
        # on this instead)
        self.batch_token = next(_collection_tokens)
        self.device = resolve_device(device)
        if options.quantization == 0:
            options.quantization = 64
        self._rng = rng if rng is not None else my_random.fork()

        if options.create_and_overwrite and os.path.exists(options.name):
            os.remove(options.name)
        existed = os.path.exists(options.name) and os.path.getsize(options.name) > 0
        if not existed:
            validate_options(options)
        self.spanlog = SpanLog(options.name)
        try:
            if existed and "" in self.spanlog:
                raw = self.spanlog.read("")[0]
                options = CollectionOptions.merge_from_json(options, raw)
            else:
                if options.index_seed == 0:
                    options.index_seed = int(self._rng.integers(1, 2**31 - 1))
                self.spanlog.write("", [options.to_json()])
            self.options = options
            validate_options(options)

            # fair FIFO lock: CPython's RLock lets a tight mutation loop
            # starve concurrent searches indefinitely (utils/locks.py)
            self._lock = FairRLock()
            self.index = hamming.SignHashIndex(
                options.dimension_count, _METRIC_NAME[options.distance_method],
                MyRandom(options.index_seed), options.index_tables,
                options.index_bits_per_table)
            from .columns import ColumnStore
            fetch = (lambda did: self.spanlog.read_stream0(str(did))) \
                if options.metadata_on_demand else None
            self.columns = ColumnStore(options.dimension_count,
                                       options.quantization,
                                       hash_words=self.index.words,
                                       metadata_fetch=fetch)
        except Exception:
            self.spanlog.close()
            if not existed:
                try:
                    os.remove(options.name)
                except OSError:
                    pass
            raise
        self._dev_version = -1
        self._dev: dict | None = None
        self._mesh = None  # parallel.mesh.Mesh: set by use_mesh
        self._hashes_stale = False
        self._closed = False
        # Adaptive provable-selection margin: the margin that proved
        # complete on a structurally tie-heavy corpus, so later searches
        # start there instead of re-climbing the ladder (see _note_margin)
        self._seg_margin_hint: Optional[int] = None
        self._hint_fail_streak = 0
        # list-mode order cache: (columns.version, ids in decimal-string
        # order); _list_sort_count counts its rebuilds
        self._sorted_ids_cache: tuple[int, list[int]] | None = None
        self._list_sort_count = 0
        # query-string filter masks keyed on the query string, each tagged
        # with the mutation generation it was evaluated at
        self._filter_cache: dict = {}
        from ..query.columnar import ColumnarFilterEngine
        self._columnar_filter = ColumnarFilterEngine()
        # device placements by kind (tests assert streaming mutations ride
        # the scatter path instead of full re-uploads)
        self.sync_stats = {"full": 0, "scatter": 0}

        if existed:
            self._replay()

    # -- properties --------------------------------------------------------

    @property
    def dimension_count(self) -> int:
        return self.options.dimension_count

    @property
    def quantization(self) -> int:
        return self.options.quantization

    @property
    def metric(self) -> str:
        return _METRIC_NAME[self.options.distance_method]

    def get_options(self) -> CollectionOptions:
        return self.options

    # -- open/replay -------------------------------------------------------

    def _replay(self) -> None:
        """Rebuild the columnar store + index from the span log (the index
        is derived data, never persisted)."""
        resident = self.columns.metadata_resident
        bulk = self.spanlog.bulk_rows(want_metas=resident)
        if bulk is not None:
            rec_ids, metas, packed = bulk
            ids = [int(r) for r in rec_ids]
        else:  # mixed record shapes: per-record decode
            ids, blobs, metas = [], [], []
            for rec_id, streams in self.spanlog.iterate():
                if rec_id == "":
                    continue
                ids.append(int(rec_id))
                if resident:
                    metas.append(bytes(streams[0]))
                blobs.append(np.frombuffer(streams[1], dtype=np.uint8))
            packed = np.stack(blobs) if ids else None
        if not resident:
            metas = [b""] * len(ids)
        if ids:
            capacity_mod.preflight(self, len(ids),
                                   sum(len(m) for m in metas))
            codes = qz.packed_to_host_repr(packed, self.dimension_count,
                                           self.quantization, consume=True)
            norms = dist_ops.db_row_stats(codes, self.quantization,
                                          self.dimension_count)
            self.columns.put_many(np.asarray(ids, dtype=np.uint64), None,
                                  metas, codes=codes, norms=norms)
        self._rebuild_index()

    def _rebuild_index(self) -> None:
        """(Re)calibrate the sketch planes; the sketches themselves are
        recomputed on the device from the uploaded codes at the next sync."""
        n = len(self.columns)
        if n == 0:
            return
        live = self.columns.live_rows()
        if not self.index.calibrated and n >= MIN_INDEX_SIZE:
            sample_rows = live if len(live) <= 1024 else \
                self._rng.choice(live, size=1024, replace=False)
            sample = qz.device_repr_to_float(self.columns.codes[sample_rows],
                                             self.quantization,
                                             self.dimension_count)
            self.index.calibrate(sample)
        self.columns.dirty_all = True  # sketches regenerate on the device
        self.columns.version += 1
        self._hashes_stale = False

    # -- mutation ----------------------------------------------------------

    def add_document(self, doc_id: int, vector: Sequence[float],
                     metadata: bytes) -> None:
        vector = np.asarray(vector, dtype=np.float64)
        if vector.shape != (self.dimension_count,):
            raise ValueError(
                f"vector size {vector.shape} does not match collection "
                f"dimension count {self.dimension_count}")
        # host prep (quantize/pack/sketch) is pure — keep it OFF the lock
        packed_rows, codes, norms = dist_ops.ingest_reprs(
            vector, self.quantization)
        packed = packed_rows[0].tobytes()
        hcode = None
        if self.index.calibrated:  # planes are immutable once calibrated
            seen = qz.device_repr_to_float(codes, self.quantization,
                                           self.dimension_count)
            hcode = self.index.encode_np(np.float32(seen))[0]
        with self._lock:
            n_new = capacity_mod.new_rows_needed(self.columns, [doc_id])
            if n_new:
                capacity_mod.preflight(self, n_new, len(metadata))
            self.spanlog.write(str(doc_id), [bytes(metadata), packed])
            row = self.columns.put(int(doc_id), vector, bytes(metadata),
                                   codes=codes[0], norm=float(norms[0]))
            if hcode is not None:
                self.columns.set_hash(row, hcode)
            elif self.index.calibrated:
                # calibration raced in between: encode under the lock
                seen = qz.device_repr_to_float(
                    self.columns.codes[row][None, :], self.quantization,
                    self.dimension_count)
                self.columns.set_hash(row, self.index.encode_np(
                    np.float32(seen))[0])
            else:
                self._hashes_stale = True

    def add_documents(self, doc_ids: Sequence[int], vectors: np.ndarray,
                      metadatas: Sequence[bytes]) -> None:
        """Vectorized bulk insert: packing, column writes and sketch
        encoding are batched, and the pure host work runs OUTSIDE the lock."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
        n = vectors.shape[0]
        if vectors.shape[1] != self.dimension_count:
            raise ValueError(
                f"vector size {vectors.shape[1]} does not match collection "
                f"dimension count {self.dimension_count}")
        if not (len(doc_ids) == n == len(metadatas)):
            raise ValueError("ids/vectors/metadatas length mismatch")
        packed, codes, norms = dist_ops.ingest_reprs(vectors,
                                                     self.quantization)
        ids_str = [str(int(i)) for i in doc_ids]
        metas = [bytes(m) for m in metadatas]
        hcodes = None
        if n <= 1024 and self.index.calibrated:
            # small batch: host-encode so the scatter sync stays cheap
            seen = qz.device_repr_to_float(codes, self.quantization,
                                           self.dimension_count)
            hcodes = self.index.encode_np(np.float32(seen))
        with self._lock:
            capacity_mod.preflight(
                self, capacity_mod.new_rows_needed(self.columns, doc_ids),
                sum(len(m) for m in metas))
            self.spanlog.write_many_columns(ids_str, metas, packed)
            rows = self.columns.put_many(np.asarray(doc_ids, dtype=np.uint64),
                                         vectors, metas, codes=codes,
                                         norms=norms)
            if hcodes is not None:
                self.columns.hashes[rows] = hcodes
            elif n <= 1024 and self.index.calibrated:
                seen = qz.device_repr_to_float(self.columns.codes[rows],
                                               self.quantization,
                                               self.dimension_count)
                self.columns.hashes[rows] = self.index.encode_np(
                    np.float32(seen))
            else:
                # bulk: sketches are recomputed on the device from the
                # uploaded codes at the next sync (device hashes are
                # authoritative)
                self.columns.dirty_all = True
                if not self.index.calibrated:
                    self._hashes_stale = True

    def add_documents_packed(self, doc_ids: Sequence[int],
                             packed: np.ndarray,
                             metadatas: Sequence[bytes]) -> None:
        """Bulk insert from PACKED storage bytes (the span-log stream-1
        representation): no float parsing, no requantization."""
        packed = np.ascontiguousarray(np.atleast_2d(packed), dtype=np.uint8)
        n = packed.shape[0]
        want = qz.vector_byte_size(self.quantization, self.dimension_count)
        if packed.shape[1] != want:
            raise ValueError(
                f"packed rows are {packed.shape[1]} bytes; a "
                f"{self.dimension_count}-d {self.quantization}-bit "
                f"collection stores {want}")
        if not (len(doc_ids) == n == len(metadatas)):
            raise ValueError("ids/packed/metadatas length mismatch")
        codes = qz.packed_to_host_repr(packed, self.dimension_count,
                                       self.quantization)
        norms = dist_ops.db_row_stats(codes, self.quantization,
                                      self.dimension_count)
        ids_str = [str(int(i)) for i in doc_ids]
        metas = [bytes(m) for m in metadatas]
        with self._lock:
            capacity_mod.preflight(
                self, capacity_mod.new_rows_needed(self.columns, doc_ids),
                sum(len(m) for m in metas))
            self.spanlog.write_many_columns(ids_str, metas, packed)
            self.columns.put_many(np.asarray(doc_ids, dtype=np.uint64),
                                  None, metas, codes=codes, norms=norms)
            self.columns.dirty_all = True
            if not self.index.calibrated:
                self._hashes_stale = True

    def get_document(self, doc_id: int) -> Document:
        with self._lock:
            if int(doc_id) not in self.columns:
                raise KeyError(doc_id)
            streams = self.spanlog.read(str(doc_id))
            vector = qz.unpack_vector(streams[1], self.dimension_count,
                                      self.quantization)
            return Document(int(doc_id), vector, bytes(streams[0]))

    def update_document(self, doc_id: int, metadata: bytes) -> None:
        """Metadata-only update; the vector (and index entry) is unchanged
        (collection.go:490-509)."""
        with self._lock:
            if int(doc_id) not in self.columns:
                raise KeyError(doc_id)
            streams = self.spanlog.read(str(doc_id))
            self.spanlog.write(str(doc_id), [bytes(metadata), streams[1]])
            self.columns.set_metadata(int(doc_id), bytes(metadata))

    def remove_document(self, doc_id: int) -> None:
        with self._lock:
            if int(doc_id) not in self.columns:
                raise KeyError(doc_id)
            self.spanlog.remove(str(doc_id))
            self.columns.remove(int(doc_id))

    # -- device cache ------------------------------------------------------

    def use_mesh(self, mesh) -> None:
        """Shard this collection's device columns over a parallel.mesh.Mesh
        with a 'data' axis (row blocks per device; searches run per shard
        and merge on the mesh's lead device — parallel/search.py).  Pass
        None to return to single-device placement."""
        if mesh is not None:
            if "data" not in mesh.shape:
                raise ValueError("mesh must have a 'data' axis")
            if mesh.shape.get("feature", 1) != 1:
                raise ValueError(
                    "collection-integrated meshes shard only the N axis; "
                    "use parallel.search directly for feature sharding")
        with self._lock:
            self._mesh = mesh
            self._dev = None
            self._dev_version = -1

    def _device_state(self) -> dict:
        """Place the columns on the device if the mutation generation
        changed: a bounded dirty-row batch at unchanged capacity is
        scattered in place (O(dirty) transfer), anything else re-places
        codes, norms, valid and the device-encoded sketches."""
        if self._hashes_stale and len(self.columns) >= MIN_INDEX_SIZE:
            self._rebuild_index()
        if self._dev is not None and self._dev_version != self.columns.version \
                and self._dev["capacity"] == self.columns.capacity:
            rows = self.columns.drain_dirty()
            if rows is not None and len(rows) <= max(
                    1024, self.columns.capacity // 8):
                if len(rows):
                    self._scatter_rows(rows)
                self.sync_stats["scatter"] += 1
                self._dev_version = self.columns.version
                return self._dev
            # too many dirty rows: fall through to a full re-placement
        if self._dev is None or self._dev_version != self.columns.version:
            self.columns.dirty_all = False
            self.columns._dirty_rows.clear()
            self.sync_stats["full"] += 1
            self._dev = None  # release the old placement before the new one
            if self._mesh is not None:
                # shard i: capacity rows [i * n_local, (i + 1) * n_local) on
                # its device (the last shard padded with invalid rows), its
                # sketches encoded there
                from ..parallel import mesh as mesh_mod
                dev = mesh_mod.place(self._mesh, self.columns.codes,
                                     self.columns.norms, self.columns.valid,
                                     bits=self.quantization)
                dev["hashes"] = [self.index.encode_codes_device(
                    c[0], self.quantization) for c in dev["codes"]]
            else:
                dev = convert.device_state_from_numpy(
                    self.columns.codes, self.columns.norms,
                    self.columns.valid, None, bits=self.quantization,
                    device=self.device)
                dev["hashes"] = self.index.encode_codes_device(
                    dev["codes"], self.quantization)
            dev["capacity"] = self.columns.capacity
            self._dev = dev
            self._dev_version = self.columns.version
        return self._dev

    def _scatter_rows(self, rows: np.ndarray) -> None:
        """Write a bounded set of mutated rows into the device columns in
        place (index_copy_); under a mesh each row goes to its shard
        (row // n_local) and is scattered there.  Searches already enqueued
        on the stream read the old rows first; later ones see the new."""
        dev = self._dev
        rows = np.asarray(rows, dtype=np.int64)
        if self._mesh is None:
            targets = [(self.device, rows, rows, dev)]
        else:
            n_local = dev["n_local"]
            shard = rows // n_local
            targets = []
            for i, d in enumerate(self._mesh.row_devices()):
                sel = rows[shard == i]
                if len(sel):
                    targets.append((d, sel, sel - i * n_local, {
                        "codes": dev["codes"][i][0], "norms": dev["norms"][i],
                        "valid": dev["valid"][i],
                        "hashes": dev["hashes"][i]}))
        for device, sel, local, cols in targets:
            idx = torch.from_numpy(local).to(device)
            upd = convert.device_state_from_numpy(
                self.columns.codes[sel], self.columns.norms[sel],
                self.columns.valid[sel], self.columns.hashes[sel],
                bits=self.quantization, device=device)
            for name, new in upd.items():
                cols[name].index_copy_(0, idx, new)

    # -- filters -----------------------------------------------------------

    _FILTER_CACHE_SIZE = 16

    def _filter_mask(self, args: SearchArgs) -> tuple[np.ndarray, int]:
        """(bool mask over capacity rows, live-passing count).

        Unfiltered searches use the validity column as is.  A query string
        evaluates in two tiers: numpy mask algebra over columnar field
        projections (query/columnar.py) where the query's shape allows,
        else one compiled-closure pass per live row; either way the mask
        is cached keyed on (query, mutation generation).  A callable
        filter is evaluated once per live row."""
        flt = args.filter
        cache_key = None
        if flt is None and not args.filter_query:
            return self.columns.valid, len(self.columns)
        if flt is None:
            cache_key = args.filter_query
            hit = self._filter_cache.get(cache_key)
            if hit is not None and hit[0] == self.columns.version:
                return hit[1], hit[2]
            vec = self._columnar_filter.evaluate(args.filter_query,
                                                 self.columns)
            if vec is not None:
                valid = self.columns.valid.copy()
                valid[: self.columns.size] &= vec
                return self._cache_mask(cache_key, valid)
            from .. import build_filter
            flt = build_filter(args.filter_query)
        valid = self.columns.valid.copy()
        for row in self.columns.live_rows():
            md = self.columns.metadata[row]
            if not flt(int(self.columns.ids[row]), md if md is not None else b""):
                valid[row] = False
        if cache_key is not None:
            return self._cache_mask(cache_key, valid)
        return valid, int(valid.sum())

    def _cache_mask(self, cache_key: str, valid: np.ndarray):
        count = int(valid.sum())
        self._filter_cache[cache_key] = (self.columns.version, valid, count)
        while len(self._filter_cache) > self._FILTER_CACHE_SIZE:
            self._filter_cache.pop(next(iter(self._filter_cache)))
        return valid, count

    # -- search ------------------------------------------------------------

    def search(self, args: SearchArgs) -> SearchResults:
        t0 = time.perf_counter()
        call = spans.next_call()
        with spans.span("dispatch", call), self._lock:
            fin = self._search_locked(args, call)
        # device path: the result fetch runs with the lock RELEASED so
        # concurrent mutations (and other searches) proceed meanwhile
        res = fin() if callable(fin) else fin
        res.search_time_ms = (time.perf_counter() - t0) * 1000.0
        return res

    def search_many(self, args_list: Sequence[SearchArgs]) -> list[SearchResults]:
        """Batched kNN: one device dispatch answers the whole query group.
        All searches must be homogeneous kNN (k > 0, no radius, vector set,
        same precision, no callable filter)."""
        return self.search_many_async(args_list)()

    def search_many_async(self, args_list: Sequence[SearchArgs]
                          ) -> Callable[[], list[SearchResults]]:
        """Pipelined search_many: DISPATCH the group's device work now (under
        the collection lock) and return a finish() callable that waits for
        the results WITHOUT the lock."""
        if not args_list:
            return lambda: []
        t0 = time.perf_counter()
        call = spans.next_call()
        with spans.span("dispatch", call):
            a0 = args_list[0]
            p0 = a0.precision or "medium"
            for a in args_list:
                if (a.k != a0.k or a.k <= 0 or a.radius != 0
                        or a.vector is None or a.filter is not None
                        or (a.precision or "medium") != p0
                        or (a.filter_query or "") != (a0.filter_query or "")):
                    raise ValueError(
                        "search_many requires homogeneous kNN searches (same "
                        "k/precision/filter_query, no radius, no callable "
                        "filter)")
            qvecs, b0 = self._batch_queries(args_list)
            with self._lock:
                n_records = len(self.columns)
                if n_records == 0:
                    fin = None
                else:
                    fin = self._knn_many_async(qvecs, a0, n_records,
                                               n_real=b0, call=call)

        def finish() -> list[SearchResults]:
            if fin is None:
                out = [SearchResults([], 0.0) for _ in args_list]
            else:
                out = fin()[:b0]
            # every member reports the group's shared dispatch wall time
            dt = (time.perf_counter() - t0) * 1000.0
            for r in out:
                r.search_time_ms = dt
            return out

        return finish

    def radius_many(self, args_list: Sequence[SearchArgs]
                    ) -> list[SearchResults]:
        """Batched radius search: one shared device escalation loop answers
        the whole group.  Searches must share precision and filter_query
        (no callable filters) but may carry DIFFERENT radii: the group
        dispatches at a shared top-k shape and escalates k until every
        member's worst returned distance clears its own radius, then each
        member keeps the rows within its radius (reference accept-reset
        semantics, collection.go:598-604).

        The device DISPATCH runs under the collection lock and the result
        FETCH with it released (escalation re-dispatches re-acquire it and
        re-read the device state)."""
        if not args_list:
            return []
        t0 = time.perf_counter()
        call = spans.next_call()
        with spans.span("dispatch", call):
            a0 = args_list[0]
            p0 = a0.precision or "medium"
            for a in args_list:
                if (a.radius <= 0 or a.vector is None
                        or a.filter is not None
                        or (a.precision or "medium") != p0
                        or (a.filter_query or "") != (a0.filter_query or "")):
                    raise ValueError(
                        "radius_many requires homogeneous radius searches "
                        "(radius > 0, same precision/filter_query, no "
                        "callable filter)")
            qvecs, b0 = self._batch_queries(args_list)
            # the pads, copies of query 0, share its radius
            radii = np.array([float(a.radius) for a in args_list])
            radii = np.concatenate(
                [radii, np.full(len(qvecs) - b0, radii[0])])
            with self._lock:
                fin = self._radius_many_async(a0, qvecs, radii, n_real=b0,
                                              call=call)
        out = fin() if callable(fin) else fin
        dt = (time.perf_counter() - t0) * 1000.0
        for r in out:
            r.search_time_ms = dt
        return out

    def _batch_queries(self, args_list: Sequence[SearchArgs]
                       ) -> tuple[np.ndarray, int]:
        """The members' vectors as one float64 batch padded to a
        power-of-two bucket (at least 8), and the number of real queries.

        The pads are COPIES of the first query, not zeros: pads ride the
        provable-selection flag like everyone else, and a zero cosine
        query's error bound is degenerate.  Copies fail exactly iff the
        real query fails (the margin hint counts real queries only)."""
        qvecs = np.stack([np.asarray(a.vector, dtype=np.float64)
                          for a in args_list])
        if qvecs.shape[1] != self.dimension_count:
            raise ValueError("query vector dimension mismatch")
        b0 = qvecs.shape[0]
        bucket = max(8, 1 << (b0 - 1).bit_length())
        if bucket != b0:
            qvecs = np.concatenate(
                [qvecs, np.repeat(qvecs[:1], bucket - b0, axis=0)])
        return qvecs, b0

    def _radius_many_async(self, args: SearchArgs, qvecs: np.ndarray,
                           radii: np.ndarray, n_real: int, call: int):
        """(Q, D)-batched radius search, split into a DISPATCH phase
        (caller holds the lock) and a finish() callable that fetches with
        the lock RELEASED; escalation rounds re-acquire it and re-read the
        device state and the filter mask.  Returns the first n_real
        queries' results directly for the host path, else the finish
        callable.  `call` identifies the call's spans (utils/spans.py)."""
        n_records = len(self.columns)
        if n_records == 0:
            return [SearchResults([], 0.0) for _ in range(n_real)]
        precision = args.precision or "medium"
        use_index = (precision not in ("exact", "high")
                     and self.index.calibrated
                     and n_records >= MIN_INDEX_SIZE)
        host = self._small() and not use_index
        dev = None if host else self._device_state()
        mask, n_passing, valid = self._filtered(args, dev, call)
        if host:
            return [self._host_scan_radius(qvecs[i], float(radii[i]), mask,
                                           n_passing, n_records)
                    for i in range(n_real)]

        nq = qvecs.shape[0]
        queries = self._queries(qvecs)

        if use_index:
            budget = min(max(self.options.search_budget,
                             4 * max(args.k, 1)), self.columns.capacity)
            qcode = self._qcodes(qvecs)
            cap = min(n_passing, self.columns.capacity)

            def ann_dispatch(dev_now, valid_now, b):
                return self._ann_topk(qcode, queries, dev_now, valid_now, b,
                                      b)

            b = budget
            dist, rows, nsc = ann_dispatch(dev, valid, b)

            def finish_ann() -> list[SearchResults]:
                bb, d, r, c = b, dist, rows, nsc
                while True:
                    dist_np, rows_np, cnt = self._fetch_results(d, r, c,
                                                                call=call)
                    if bb >= cap or all(
                            self._radius_done(dist_np[i], bb, radii[i], 0.0)
                            for i in range(n_real)):
                        break
                    bb = min(bb * 4, cap)
                    # escalation re-dispatch
                    with spans.span("escalate", call), self._lock:
                        spans.add("escalate_q", nq)
                        dev2 = self._device_state()
                        d, r, c = ann_dispatch(
                            dev2, self._filtered(args, dev2, call)[2], bb)
                searched = min(bb, n_passing)
                # result assembly reads host columns
                with spans.span("results", call), self._lock:
                    return [self._radius_results_np(
                        dist_np[i], rows_np[i], float(radii[i]),
                        int(cnt[i]) if cnt is not None else searched,
                        n_records) for i in range(n_real)]

            return self._leased_finish(finish_ann)

        # exhaustive: shared top-kk with k escalation (one dispatch per
        # round serves the whole group), each kk proven by the margin ladder
        searched = n_passing
        exact = precision == "exact"
        eps = self._F32_EPS_REL * np.maximum(1.0, radii) if exact \
            else np.zeros_like(radii)
        kk0 = min(1024, n_passing)
        tmargin0 = self._seg_margin_hint
        version0 = self.columns.version
        dispatched0 = self._exact_topk_device(queries, dev, valid, kk0,
                                              tie_margin=tmargin0)

        def finish_exh() -> list[SearchResults]:
            kk, tm, ver, dispatched = kk0, tmargin0, version0, dispatched0
            first_fail = None
            while True:
                dist_np, rows_np, tm, fail = self._proven_topk(
                    queries, args, kk, dispatched, tm, ver, n_real, call=call)
                first_fail = fail if first_fail is None else first_fail
                with self._lock:
                    self._note_margin(tm, first_fail, kk=kk, n_real=n_real)
                if kk >= n_passing or all(
                        self._radius_done(dist_np[i], kk, radii[i], eps[i])
                        for i in range(n_real)):
                    break
                kk = min(kk * 4, n_passing)
                # k escalation re-dispatch
                with spans.span("escalate", call), self._lock:
                    spans.add("escalate_q", nq)
                    dev2 = self._device_state()
                    ver = self.columns.version
                    dispatched = self._exact_topk_device(
                        queries, dev2, self._filtered(args, dev2, call)[2],
                        kk, tie_margin=tm)
            out = []
            # result assembly reads host columns
            with spans.span("results", call), self._lock:
                for i in range(n_real):
                    if exact:
                        rows_i = rows_np[i][np.isfinite(dist_np[i])]
                        out.append(self._radius_results_f64(
                            qvecs[i], rows_i, float(radii[i]), searched,
                            n_records))
                    else:
                        out.append(self._radius_results_np(
                            dist_np[i], rows_np[i], float(radii[i]),
                            searched, n_records))
            return out

        return self._leased_finish(finish_exh)

    @staticmethod
    def _radius_done(dist_row: np.ndarray, kk: int, radius: float,
                     eps: float) -> bool:
        """One query's escalation stop test: its candidate set is complete
        when fewer than kk rows came back finite or the worst returned
        distance already exceeds its radius (+ the exact-mode f32
        cushion)."""
        finite = dist_row[np.isfinite(dist_row)]
        return len(finite) < kk or \
            (len(finite) > 0 and finite[-1] > radius + eps)

    def _radius_results_np(self, dist: np.ndarray, rows: np.ndarray,
                           radius: float, searched: int,
                           n_records: int) -> SearchResults:
        """Assemble one query's radius results from fetched arrays."""
        keep = np.isfinite(dist) & (dist <= radius)
        return self._results(rows[keep].tolist(), dist[keep].tolist(),
                             self._pct(searched, n_records))

    def _search_locked(self, args: SearchArgs, call: int):
        """Dispatch one search under the caller's lock: device kNN returns a
        finish() CALLABLE; list mode and host scans return SearchResults.
        `call` identifies the call's spans (utils/spans.py)."""
        n_records = len(self.columns)
        if args.k == 0 and args.radius == 0:
            return self._list_mode(args, n_records)
        if args.vector is None:
            raise ValueError("search requires a vector when k or radius is set")
        qvec = np.asarray(args.vector, dtype=np.float64)
        if qvec.shape != (self.dimension_count,):
            raise ValueError("query vector dimension mismatch")
        if n_records == 0:
            return SearchResults([], 0.0)
        if args.radius > 0:
            return self._radius_search(args, qvec, call)
        fin = self._knn_many_async(qvec[None, :], args, n_records, call=call)
        return lambda: fin()[0]

    def _small(self) -> bool:
        """Small-collection host path: below HOST_SCAN_MAX_ELEMS stored
        elements a host f64 scan answers without touching the device (never
        under a mesh)."""
        return (self._mesh is None and self.columns.size *
                self.dimension_count <= HOST_SCAN_MAX_ELEMS)

    def _exact_topk_device(self, queries, dev, valid, kk: int,
                           tie_margin: Optional[int] = None):
        """Exhaustive device top-k over all rows for (Q, D) queries.

        Returns (dist, rows, ok_flags, s_used, nseg).  Where ok == 1 the
        result is PROVABLY the true top-k; otherwise the caller re-dispatches
        with an escalated tie_margin, until s_used reaches nseg (every
        segment or row selected).  Past the fused bound (large k, or a large
        batch at radius k) the dispatch selects rows from kernel K4's full
        surface (scan.surface_topk): its margin, s_used and nseg count rows,
        a margin of m segments standing for the m * 32 rows they hold.
        Under a mesh every data shard does the same on its rows
        (parallel/search.sharded_exact_topk: fused when kk <= 128), its s_used
        and nseg counting one shard's segments or rows."""
        if self._mesh is None:
            n = self.columns.capacity
            fused = scan.fused_k_ok(kk, queries.shape[0])
            margin = scan.DEFAULT_TIE_MARGIN
        else:
            from ..parallel import search as psearch
            n = dev["n_local"]
            fused = psearch.fused_ok(kk, n)
            margin = psearch.DEFAULT_MESH_SEG_MARGIN
        if tie_margin is not None:
            margin = tie_margin
        elif fused and kk > scan.MAX_FUSED_K:
            # large k: tie density at the k-th value scales with k
            margin = max(margin, 64)
        row_margin = min(margin * scan.DEFAULT_SEG, n)
        if self._mesh is not None:
            dist, rows, ties = psearch.sharded_exact_topk(
                self._mesh, queries, dev["codes"], dev["norms"], valid,
                bits=self.quantization, metric=self.metric, k=kk,
                seg_margin=margin, with_ties=True)
        elif fused:
            dist, rows, ties = scan.fused_scan_topk(
                queries, dev["codes"], dev["norms"], valid,
                bits=self.quantization, metric=self.metric, k=kk,
                tie_margin=margin, with_ties=True)
        else:
            dist, rows, ties = scan.surface_topk(
                queries, dev["codes"], dev["norms"], valid,
                bits=self.quantization, metric=self.metric, k=kk,
                margin=row_margin)
        if fused:
            nseg = n // scan.DEFAULT_SEG
            return dist, rows, ties, min(kk + margin, nseg), nseg
        return dist, rows, ties, min(kk + row_margin, n), n

    def _ann_topk(self, qcode, queries, dev, valid, budget: int, k: int):
        """The sketch route: K2 candidates and their fp32 rerank -> (dist,
        rows, nscored); under a mesh each data shard ranks its own rows
        with budget / shards candidates (parallel/search.sharded_ann_topk)."""
        if self._mesh is not None:
            from ..parallel import search as psearch
            shards = self._mesh.shape["data"]
            return psearch.sharded_ann_topk(
                self._mesh, qcode, queries, dev["codes"], dev["norms"],
                dev["hashes"], valid, bits=self.quantization,
                metric=self.metric, k=k, local_budget=max(1, budget // shards),
                with_counts=True)
        _, cand = hamming.hamming_candidates(qcode, dev["hashes"], valid,
                                             budget)
        return hamming.rerank_topk(queries, dev["codes"], dev["norms"], valid,
                                   cand, self.quantization, self.metric, k,
                                   with_counts=True)

    def _leased_finish(self, fin: Callable) -> Callable:
        """Hold a column-store snapshot lease across a deferred result
        assembly: rows freed while a fetch is in flight are quarantined, so
        assembly never pairs a NEW document's id with an OLD distance.
        Caller must hold self._lock."""
        self.columns.begin_lease()
        done = [False]

        def finish_leased():
            try:
                return fin()
            finally:
                with self._lock:
                    if not done[0]:
                        done[0] = True
                        self.columns.end_lease()
        return finish_leased

    def _lead(self) -> torch.device:
        """Where queries are built and results land: the mesh's lead device,
        else the collection's."""
        return self.device if self._mesh is None else self._mesh.lead

    def _queries(self, qvecs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.float32(qvecs)).to(self._lead())

    def _qcodes(self, qvecs: np.ndarray) -> torch.Tensor:
        """The queries' sketches (int32 words) on the lead device."""
        return torch.from_numpy(self.index.encode_np(
            np.float32(qvecs)).view(np.int32)).to(self._lead())

    def _filtered(self, args: SearchArgs, dev: Optional[dict], call: int):
        """The filter's work for one dispatch or escalation round -> (bool
        mask over capacity rows, live-passing count, the validity column
        the device search runs with, None when `dev` is None).

        Unfiltered, the validity column and its placed copy as they are.
        Filtered, inside the span "filter" of call `call`: the mask
        (_filter_mask: query strings hit the mask cache) and its upload to
        the device, under a mesh split into each shard's rows on its
        device."""
        if args.filter is None and not args.filter_query:
            mask, n_passing = self._filter_mask(args)
            return mask, n_passing, None if dev is None else dev["valid"]
        with spans.span("filter", call):
            mask, n_passing = self._filter_mask(args)
            if dev is None:
                valid = None
            elif self._mesh is None:
                valid = torch.from_numpy(mask).to(self.device)
            else:
                from ..parallel import mesh as mesh_mod
                valid = [torch.from_numpy(m).to(d) for m, d in zip(
                    mesh_mod.split_rows(self._mesh, mask, dev["n_local"]),
                    self._mesh.row_devices())]
        return mask, n_passing, valid

    def _knn_many_async(self, qvecs: np.ndarray, args: SearchArgs,
                        n_records: int, n_real: Optional[int] = None, *,
                        call: int) -> Callable[[], list[SearchResults]]:
        """kNN for a (Q, D) batch sharing precision/filter, split into a
        DISPATCH phase (now, caller holds the lock) and a returned finish()
        that fetches with the lock RELEASED.  n_real = the number of REAL
        queries when the batch is bucket-padded with copies of qvecs[0]:
        the margin hint's failure fraction counts real queries only.
        `call` identifies the call's spans (utils/spans.py)."""
        precision = args.precision or "medium"
        nq = qvecs.shape[0]
        n_real = nq if n_real is None else n_real

        use_index = (precision not in ("exact", "high")
                     and self.index.calibrated
                     and n_records >= MIN_INDEX_SIZE)
        if use_index:
            budget = min(max(self.options.search_budget,
                             4 * max(args.k, 1)), self.columns.capacity)
            # adaptive medium (ANN_BATCH_CROSSOVER): large batches take the
            # exhaustive scan, which also reads every row once
            if nq * budget * ANN_BATCH_CROSSOVER >= n_records:
                use_index = False
        host = self._small() and not use_index
        dev = None if host else self._device_state()
        mask, n_passing, valid = self._filtered(args, dev, call)
        k = min(args.k, n_passing)
        if host:
            out = self._host_scan_knn(qvecs, k, mask, n_passing, n_records)
            return lambda: out

        queries = self._queries(qvecs)

        if use_index:
            searched = min(budget, n_passing)
            if k == 0:
                out = [SearchResults([], self._pct(searched, n_records))
                       for _ in range(nq)]
                return lambda: out
            dist, rows, nsc = self._ann_topk(self._qcodes(qvecs), queries,
                                             dev, valid, budget, k)

            def finish_ann() -> list[SearchResults]:
                dist_np, rows_np, cnt = self._fetch_results(dist, rows, nsc,
                                                            call=call)
                # result assembly reads host columns
                with spans.span("results", call), self._lock:
                    return self._knn_results_np(dist_np, rows_np, k,
                                                searched, n_records, cnt)

            return self._leased_finish(finish_ann)

        # exhaustive device scan
        searched = n_passing
        if k == 0:
            out = [SearchResults([], self._pct(searched, n_records))
                   for _ in range(nq)]
            return lambda: out
        if precision == "exact":
            # exact mode interleaves host f64 reranks with escalation
            # re-dispatches: stays synchronous under the caller's lock
            out = self._exact_knn_f64(qvecs, queries, args, dev, valid, k,
                                      n_passing, searched, n_records,
                                      n_real=n_real, call=call)
            return lambda: out
        tmargin = self._seg_margin_hint
        # the mutation generation the batch's answers come from
        version = self.columns.version
        dispatched = self._exact_topk_device(queries, dev, valid, k,
                                             tie_margin=tmargin)

        def finish_escalate() -> list[SearchResults]:
            dist_np, rows_np, tm, first_fail = self._proven_topk(
                queries, args, k, dispatched, tmargin, version, n_real,
                call=call)
            with spans.span("results", call), self._lock:
                self._note_margin(tm, first_fail, kk=k, n_real=n_real)
                return self._knn_results_np(dist_np, rows_np, k, searched,
                                            n_records)

        return self._leased_finish(finish_escalate)

    def _proven_topk(self, queries, args: SearchArgs, kk: int, dispatched,
                     tmargin: Optional[int], version: int, n_real: int, *,
                     call: int):
        """The margin ladder of every exhaustive finish: fetch
        `dispatched`, _exact_topk_device(queries, ..., kk, tie_margin=
        tmargin) made on mutation generation `version`, and climb until
        every flag is 1 or the selection holds every segment.

        A round re-dispatches the queries whose flag is 0 at the next rung
        on the CURRENT device state and filter mask (re-read under the
        lock); the others keep their answers, which their flags proved.
        After a write since `version`, or when every query failed, the
        whole batch goes again, so that all its answers come from one
        state.  Returns host (dist, rows, the last round's margin, the
        first fetch's failure fraction over the n_real real queries)."""
        dist, rows, ties, s_used, nseg = dispatched
        tm, ver, sel, first_fail = tmargin, version, None, None
        while True:
            got = self._fetch_results(dist, rows, ties, call=call)
            if sel is None:
                dist_np, rows_np, tie_np = got
            else:
                dist_np[sel], rows_np[sel], tie_np[sel] = got
            if first_fail is None:
                first_fail = 1.0 - float(tie_np[:n_real].mean())
            if s_used >= nseg or int(tie_np.min()) == 1:
                return dist_np, rows_np, tm, first_fail
            with spans.span("escalate", call), self._lock:
                tm = self._escalate_margin(tm)
                dev = self._device_state()
                sel = np.flatnonzero(tie_np == 0)
                if len(sel) == len(tie_np) or self.columns.version != ver:
                    sel, q, ver = None, queries, self.columns.version
                else:
                    q = queries.index_select(0, torch.from_numpy(sel).to(
                        queries.device))
                spans.add("escalate_q", q.shape[0])
                dist, rows, ties, s_used, nseg = self._exact_topk_device(
                    q, dev, self._filtered(args, dev, call)[2], kk,
                    tie_margin=tm)

    # A starting-margin failure is "structural" when at least this fraction
    # of the batch's REAL queries tripped the flag; below it the failure is
    # an outlier query that escalates its own dispatch but must not widen
    # every future search's rerank (hint poisoning).
    _HINT_FAIL_FRAC = 0.01
    # below this many real queries, require _HINT_STREAK consecutive
    # failing searches before setting the hint
    _HINT_MIN_BATCH = 64
    _HINT_STREAK = 3

    def _note_margin(self, tmargin: Optional[int],
                     fail_frac: float = 1.0, kk: int = 0,
                     n_real: int = 1 << 30) -> None:
        """Record the tie margin a completed dispatch needed so the next
        search starts there (monotone max; only ever widens the rerank).
        Skipped for non-structural failures and for large-k dispatches."""
        if kk > scan.MAX_FUSED_K:
            return
        if fail_frac < self._HINT_FAIL_FRAC:
            self._hint_fail_streak = 0
            return
        if n_real < self._HINT_MIN_BATCH:
            self._hint_fail_streak += 1
            if self._hint_fail_streak < self._HINT_STREAK:
                return
        if tmargin is not None and tmargin > (self._seg_margin_hint or 0):
            self._seg_margin_hint = tmargin

    # Escalation rungs for the provable-selection margin; past the ladder
    # the dispatch gathers every segment (complete by construction).
    _MARGIN_LADDER = (64, 512, 8192)

    def _escalate_margin(self, cur: Optional[int]) -> int:
        have = cur or 0
        for m in self._MARGIN_LADDER:
            if m > have:
                return m
        return 1 << 30

    # error bound of the f32 device distances vs true f64 values, relative
    # to the distance magnitude (f32 accumulation + 64->32-bit truncation);
    # generous on purpose — too small breaks the shortlist proof, too large
    # merely escalates more often
    _F32_EPS_REL = 3e-4

    def _rows_vectors_f64(self, rows: np.ndarray) -> np.ndarray:
        """Exact f64 dequantized vectors for the given rows (the host column
        store is lossless at every width; 64-bit stays f64 host-side)."""
        return qz.device_repr_to_float(self.columns.codes[rows],
                                       self.quantization,
                                       self.dimension_count)

    def _exact_knn_f64(self, qvecs, queries, args: SearchArgs, dev, valid,
                       k: int, n_passing: int, searched: int, n_records: int,
                       n_real: int, *, call: int) -> list[SearchResults]:
        """precision="exact" above the host-scan threshold: the device
        produces a provably complete f32 top-(k+margin) shortlist, and the
        final ranking is recomputed on the host in f64.  The shortlist
        widens (the whole batch) until the f64 k-th best is provably
        separated from the shortlist boundary (boundary > d64_k + eps).
        Runs synchronously under the caller's lock."""
        pct = self._pct(searched, n_records)
        m = max(64, k)
        kk = min(k + m, n_passing)
        tm = self._seg_margin_hint
        dispatched = self._exact_topk_device(queries, dev, valid, kk,
                                             tie_margin=tm)
        first_fail = None
        while True:
            dist_np, rows_np, tm, fail = self._proven_topk(
                queries, args, kk, dispatched, tm, self.columns.version,
                n_real, call=call)
            first_fail = fail if first_fail is None else first_fail
            self._note_margin(tm, first_fail, kk=kk, n_real=n_real)
            with spans.span("results", call):
                out = []
                for qi in range(qvecs.shape[0]):
                    fin = np.isfinite(dist_np[qi])
                    cand = rows_np[qi][fin]
                    d64 = dist_ops.distance_np(
                        qvecs[qi][None, :], self._rows_vectors_f64(cand),
                        self.metric)
                    order = np.argsort(d64, kind="stable")[:k]
                    if len(cand) == kk and kk < n_passing:
                        boundary = float(dist_np[qi][fin][-1])
                        eps = self._F32_EPS_REL * max(1.0, abs(boundary))
                        if float(d64[order[-1]]) + eps >= boundary:
                            break  # not separated: widen the shortlist
                    out.append(self._results(cand[order].tolist(),
                                             d64[order].tolist(), pct))
                else:
                    return out
            m *= 4
            kk = min(k + m, n_passing)
            # shortlist widening re-dispatch
            with spans.span("escalate", call):
                spans.add("escalate_q", queries.shape[0])
                dispatched = self._exact_topk_device(queries, dev, valid, kk,
                                                     tie_margin=tm)

    def _radius_search(self, args: SearchArgs, qvec: np.ndarray,
                       call: int):
        """Single-query radius search: the Q=1 case of the batched
        escalation loop.  Returns SearchResults (host path) or a finish()
        callable (device paths: the fetch runs without the caller's
        lock)."""
        out = self._radius_many_async(
            args, qvec[None, :], np.array([float(args.radius)]), n_real=1,
            call=call)
        if callable(out):
            return lambda: out()[0]
        return out[0]

    def _radius_results_f64(self, qvec: np.ndarray, rows_np: np.ndarray,
                            radius: float, searched: int,
                            n_records: int) -> SearchResults:
        """f64 re-filter and re-sort of the device shortlist (exact
        mode)."""
        if len(rows_np) == 0:
            return SearchResults([], self._pct(searched, n_records))
        d64 = dist_ops.distance_np(
            np.asarray(qvec, dtype=np.float64)[None, :],
            self._rows_vectors_f64(rows_np), self.metric)
        keep = np.flatnonzero(d64 <= radius)
        order = keep[np.argsort(d64[keep], kind="stable")]
        return self._results(rows_np[order].tolist(), d64[order].tolist(),
                             self._pct(searched, n_records))

    def _host_scan_radius(self, qvec: np.ndarray, radius: float,
                          mask: np.ndarray, n_passing: int,
                          n_records: int) -> SearchResults:
        """Exhaustive radius scan on the host in f64 (small collections)."""
        size = self.columns.size
        live = np.flatnonzero(mask[:size])
        pct = self._pct(n_passing, n_records)
        if len(live) == 0:
            return SearchResults([], pct)
        vecs = qz.device_repr_to_float(self.columns.codes[live],
                                       self.quantization,
                                       self.dimension_count)
        d = dist_ops.distance_np(qvec[None, :], vecs, self.metric)
        hit = np.flatnonzero(d <= radius)
        order = hit[np.argsort(d[hit], kind="stable")]
        return self._results(live[order].tolist(), d[order].tolist(), pct)

    def _host_scan_knn(self, qvecs: np.ndarray, k: int, mask: np.ndarray,
                       n_passing: int, n_records: int) -> list[SearchResults]:
        """Exhaustive host scan in f64 for a batch of kNN queries."""
        size = self.columns.size
        live = np.flatnonzero(mask[:size])
        pct = self._pct(n_passing, n_records)
        if len(live) == 0 or k == 0:
            return [SearchResults([], pct) for _ in range(len(qvecs))]
        vecs = qz.device_repr_to_float(self.columns.codes[live],
                                       self.quantization,
                                       self.dimension_count)
        out = []
        for qi in range(len(qvecs)):
            d = dist_ops.distance_np(qvecs[qi][None, :], vecs, self.metric)
            part = np.argpartition(d, k - 1)[:k]
            order = part[np.argsort(d[part], kind="stable")]
            out.append(self._results(live[order].tolist(),
                                     d[order].tolist(), pct))
        return out

    # -- result assembly ---------------------------------------------------

    def _pct(self, searched: int, n_records: int) -> float:
        return 0.0 if n_records == 0 else searched / n_records * 100.0

    def _mk_result(self, row: int, d: float) -> SearchResult:
        md = self.columns.metadata[row]
        return SearchResult(self.columns.ids.item(row),
                            md if md is not None else b"", d)

    def _results(self, rows, dists, pct: float) -> SearchResults:
        """One query's SearchResults from its rows and distances, in order,
        as Python ints and floats (from .tolist(): numpy scalars cost more
        per element)."""
        mk = self._mk_result
        return SearchResults([mk(r, d) for r, d in zip(rows, dists)], pct)

    @staticmethod
    def _fetch_results(dist, rows, counts=None, *, call: int):
        """Device -> host copy of (dist, rows[, counts]), with the wait for
        the device work they read: call `call`'s "fetch" span."""
        with spans.span("fetch", call):
            cnt = None if counts is None else counts.cpu().numpy()
            return (dist.to(torch.float32).cpu().numpy(), rows.cpu().numpy(),
                    cnt)

    def _knn_results_np(self, dist, rows, k: int, searched: int,
                        n_records: int, cnt=None) -> list[SearchResults]:
        """Assemble each query's first k finite (row, distance) pairs.

        Each column becomes Python objects by one flat tolist() a call, not
        one scalar at a time; a nested tolist() would add a tracked list per
        query, which the collector pays for."""
        dist, rows = dist[:, :k], rows[:, :k]
        nq, kk = dist.shape
        dl = dist.ravel().tolist()
        rl = rows.ravel().tolist()
        fin = np.isfinite(dist)
        fl = None if fin.all() else fin.ravel().tolist()
        if cnt is None:
            pcts = itertools.repeat(self._pct(searched, n_records), nq)
        else:
            pcts = [self._pct(c, n_records) for c in cnt.tolist()]
        out = []
        for qi, pct in zip(range(nq), pcts):
            a, b = qi * kk, qi * kk + kk
            r, d = rl[a:b], dl[a:b]
            if fl is not None:
                r = itertools.compress(r, fl[a:b])
                d = itertools.compress(d, fl[a:b])
            out.append(self._results(r, d, pct))
        return out

    def _sorted_doc_ids(self) -> list[int]:
        """Doc ids in lexicographic decimal-string order (the reference's
        IterateSortedRecords quirk, spanfile.go:541-547), cached per
        mutation generation."""
        ver = self.columns.version
        cached = self._sorted_ids_cache
        if cached is None or cached[0] != ver:
            self._list_sort_count += 1
            ids = sorted(((str(i), int(i)) for i in self.columns.doc_ids()),
                         key=lambda p: p[0])
            cached = (ver, [p[1] for p in ids])
            self._sorted_ids_cache = cached
        return cached[1]

    def _list_mode(self, args: SearchArgs, n_records: int) -> SearchResults:
        ordered = self._sorted_doc_ids()
        flt = args.filter
        if flt is None and args.filter_query:
            from .. import build_filter
            flt = build_filter(args.filter_query)
        if flt is None:
            # "considered" counts records visited by the sequential walk
            # (offset skips still visit, collection.go:643-668)
            if args.limit:
                page = ordered[args.offset:args.offset + args.limit]
            else:
                page = ordered[args.offset:]
            if args.limit and len(page) == args.limit:
                considered = args.offset + args.limit
            else:
                considered = len(ordered)
            results = [SearchResult(i, self.columns.get_metadata(i), 0.0)
                       for i in page]
            return SearchResults(results, self._pct(considered, n_records))

        results = []
        skipped = 0
        considered = 0  # filter-passing records visited
        for doc_id in ordered:
            md = self.columns.get_metadata(doc_id)
            if not flt(doc_id, md):
                continue
            considered += 1
            if skipped < args.offset:
                skipped += 1
                continue
            results.append(SearchResult(doc_id, md, 0.0))
            if args.limit and len(results) >= args.limit:
                break
        return SearchResults(results, self._pct(considered, n_records))

    # -- stats & misc ------------------------------------------------------

    def metadata_json_ok(self, result: SearchResult) -> bool:
        """Memoized JSON-validity check of a result's metadata bytes: the
        REST layer splices valid bytes verbatim into the response instead of
        parsing and re-serializing each result.

        The memo is row-indexed; metadata writes reset the row's bit
        (ColumnStore), and the bytes-identity check below also guards a
        rewrite landing between this validation and the memo store, so
        bytes that were not validated are never memoized as valid."""
        md = result.metadata
        if not md:
            return False
        cols = self.columns
        if not cols.metadata_resident:
            # out-of-core metadata: every read returns fresh bytes from the
            # span log, so the identity guard cannot hold — validate per
            # result, never memoize
            try:
                json.loads(md)
                return True
            except Exception:
                return False
        row = cols._row_of.get(result.id)  # GIL-atomic dict read
        if row is not None and row < len(cols.meta_ok) and \
                cols.meta_ok[row] and cols.metadata[row] is md:
            return True
        try:
            json.loads(md)
        except Exception:
            return False
        if row is not None and row < len(cols.meta_ok) and \
                cols.metadata[row] is md:
            cols.meta_ok[row] = True
            if cols.metadata[row] is not md:
                # a rewrite raced between the identity check and the memo
                # store: never leave True standing for unvalidated bytes
                cols.meta_ok[row] = False
        return True

    def get_document_count(self) -> int:
        return len(self.columns)

    def get_all_ids(self) -> list[int]:
        return sorted(self.columns.doc_ids())

    def iter_export_rows(self, chunk: int = 8192, raw: bool = False):
        """Yield (ids, vectors, metadatas) chunks in ascending uint64 id
        order for JSON export: one bulk span decode and a vectorized
        dequantization, with the same values as get_document's.  With
        raw=True the chunks hold the (m, B) uint8 storage rows instead of
        f64 vectors.  Mixed logs fall back to per-record reads.

        An out-of-core metadata collection exports at bounded memory: the
        codes ride the streamed bulk_rows(want_metas=False) path (as the
        reopen replay does) and each chunk's metadata is read on demand.
        A record removed while the export runs is skipped."""
        resident = self.columns.metadata_resident
        bulk = self.spanlog.bulk_rows(want_metas=resident)
        if bulk is None:  # mixed record shapes
            for doc_id in self.get_all_ids():
                try:
                    streams = self.spanlog.read(str(int(doc_id)))
                except KeyError:
                    continue  # removed concurrently
                if raw:
                    row = np.frombuffer(streams[1], dtype=np.uint8)[None]
                else:
                    row = qz.unpack_vector(streams[1], self.dimension_count,
                                           self.quantization)[None]
                yield [int(doc_id)], row, [bytes(streams[0])]
            return
        rec_ids, metas, packed = bulk
        if not rec_ids:
            return
        # uint64: doc ids span the whole unsigned range
        ids = np.array([int(r) for r in rec_ids], dtype=np.uint64)
        order = np.argsort(ids, kind="stable")
        for s in range(0, len(order), chunk):
            sel = order[s:s + chunk]
            if resident:
                chunk_metas = [metas[i] for i in sel.tolist()]
            else:
                chunk_metas, kept = [], []
                for i in sel.tolist():
                    try:
                        chunk_metas.append(
                            self.spanlog.read_stream0(rec_ids[i]))
                        kept.append(i)
                    except KeyError:
                        continue  # removed concurrently
                if not kept:
                    continue
                sel = np.array(kept, dtype=np.int64)
            rows = packed[sel] if raw else qz.unpack_vectors(
                packed[sel], self.dimension_count, self.quantization)
            yield ids[sel].tolist(), rows, chunk_metas

    def compute_average_distance(self, samples: int = 100) -> float:
        with self._lock:
            ids = self.columns.doc_ids()
            if len(ids) < 2 or samples <= 0:
                return 0.0
            total = 0.0
            for _ in range(samples):
                a, b = self._rng.choice(len(ids), size=2, replace=False)
                va = self.columns.get_vector(ids[int(a)])
                vb = self.columns.get_vector(ids[int(b)])
                total += float(dist_ops.distance_np(va, vb, self.metric))
            return total / samples

    def compute_stats(self) -> CollectionStats:
        size, _ = self.spanlog.stats()
        return CollectionStats(
            document_count=len(self.columns),
            dimension_count=self.dimension_count,
            quantization=self.quantization,
            distance_method=self.metric,
            storage_size=size,
            average_distance=self.compute_average_distance(100),
        )

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self.spanlog.close()
                self._dev = None
                self._closed = True

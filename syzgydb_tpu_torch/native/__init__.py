"""ctypes bindings for the native span-log core (root native/spanlog_core.cpp)
and the JSON field projector (root native/jsonproj.cpp).

The port builds the shared repo sources into ITS OWN directory
(syzgydb_tpu_torch/native/lib*.so, on first use when g++ is available) and
never touches the JAX package's copies.  storage.py and query/columnar.py
fall back to their pure-Python paths (host parsing) when no library loads,
so the native libraries are accelerators, never requirements.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libspanlog_core.so")
_SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")

_lib = None


def _build_lib(src_name: str, lib_path: str) -> None:
    """Compile to a unique temp path then os.replace into place: a
    concurrent or timed-out build must never leave a partial .so that
    os.path.exists() then treats as final, permanently disabling the
    accelerator."""
    src = os.path.join(_SRC_DIR, src_name)
    if not os.path.exists(src):
        return
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-D_GNU_SOURCE",
             src, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _try_build() -> None:
    _build_lib("spanlog_core.cpp", _LIB_PATH)


def get_lib():
    """Returns the loaded library or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _try_build()
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.slc_crc32.restype = ctypes.c_uint32
    lib.slc_crc32.argtypes = [u8p, ctypes.c_uint64]
    lib.slc_encoded_size.restype = ctypes.c_uint64
    lib.slc_encoded_size.argtypes = [ctypes.c_uint64, u32p, ctypes.c_uint32,
                                     u32p]
    lib.slc_encode_batch.restype = ctypes.c_uint64
    lib.slc_encode_batch.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint8, u8p, u32p,
        ctypes.c_uint32, u8p, u32p, u8p, u64p, u64p]
    lib.slc_encode_batch_split.restype = ctypes.c_uint64
    lib.slc_encode_batch_split.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint8, u8p, u32p,
        ctypes.c_uint32, ctypes.POINTER(u8p), u32p, u8p, u64p, u64p]
    lib.slc_scan.restype = ctypes.c_uint64
    lib.slc_scan.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u64p,
                             u64p, u64p, u8p, u64p, u32p]
    _lib = lib
    return _lib


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _fields_fit(id_lens: np.ndarray, nstreams: int,
                stream_lens64: np.ndarray) -> bool:
    """The record format holds u16 id_len / u8 nstreams / u32 lengths;
    the C encoder would silently truncate oversized values into
    CRC-valid but semantically corrupt records (confirmed: a 70000-byte
    id wrote id_len 4464 and reopened as garbage).
    Oversized inputs take the python path, which raises struct.error."""
    if nstreams > 0xFF:
        return False
    if id_lens.size and int(id_lens.max()) > 0xFFFF:
        return False
    if stream_lens64.size:
        if int(stream_lens64.max()) > 0xFFFFFFFF:
            return False
        body = 12 + id_lens.astype(np.int64) + \
            (stream_lens64 + 4).sum(axis=1)
        if int(body.max()) > 0xFFFFFFFF:
            return False
    return True


def encode_batch(first_seq: int, flags: int, rec_ids: list[bytes],
                 streams_per_record: list[list[bytes]]):
    """-> (buffer bytes, offsets np.uint64, lengths np.uint64) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rec_ids)
    if n == 0:
        return b"", np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    nstreams = len(streams_per_record[0])
    if any(len(s) != nstreams for s in streams_per_record):
        return None  # mixed stream counts: python fallback
    ids_cat = np.frombuffer(b"".join(rec_ids), dtype=np.uint8) \
        if any(rec_ids) else np.zeros(0, np.uint8)
    id_lens = np.array([len(r) for r in rec_ids], dtype=np.uint32)
    stream_lens64 = np.array(
        [len(s) for rec in streams_per_record for s in rec],
        dtype=np.int64).reshape(n, max(nstreams, 1))
    if not _fields_fit(id_lens, nstreams, stream_lens64):
        return None  # python fallback raises struct.error loudly
    stream_lens = stream_lens64.astype(np.uint32)
    payload = b"".join(s for rec in streams_per_record for s in rec)
    payload_arr = np.frombuffer(payload, dtype=np.uint8) if payload \
        else np.zeros(0, np.uint8)

    total = lib.slc_encoded_size(
        n, id_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), nstreams,
        stream_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    out = np.empty(int(total), dtype=np.uint8)
    offsets = np.empty(n, dtype=np.uint64)
    lengths = np.empty(n, dtype=np.uint64)
    written = lib.slc_encode_batch(
        n, first_seq, flags, _as_u8p(np.ascontiguousarray(ids_cat)),
        id_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), nstreams,
        _as_u8p(np.ascontiguousarray(payload_arr)),
        stream_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _as_u8p(out),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    assert written == total
    return out.tobytes(), offsets, lengths


def encode_batch_split(first_seq: int, flags: int, rec_ids: list[bytes],
                       stream_bufs: list, stream_lens: np.ndarray):
    """Columnar variant of encode_batch: stream s of every record arrives
    pre-concatenated in stream_bufs[s] (bytes or uint8 ndarray);
    stream_lens is (n, nstreams) uint32.  The bulk-ingest path hands the
    vector stream over as one contiguous array — no per-row slicing.
    -> (buffer bytes, offsets, lengths) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rec_ids)
    nstreams = int(stream_lens.shape[1]) if stream_lens.ndim == 2 else 0
    if n == 0 or nstreams == 0:
        return b"", np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    ids_cat = np.frombuffer(b"".join(rec_ids), dtype=np.uint8) \
        if any(rec_ids) else np.zeros(0, np.uint8)
    id_lens = np.array([len(r) for r in rec_ids], dtype=np.uint32)
    if not _fields_fit(id_lens, nstreams,
                       np.asarray(stream_lens, dtype=np.int64)):
        return None  # python fallback raises struct.error loudly
    stream_lens = np.ascontiguousarray(stream_lens, dtype=np.uint32)

    bufs = []
    for sb in stream_bufs:
        a = np.frombuffer(sb, dtype=np.uint8) if isinstance(
            sb, (bytes, bytearray, memoryview)) else \
            np.ascontiguousarray(sb, dtype=np.uint8).reshape(-1)
        bufs.append(a if a.size else np.zeros(1, np.uint8))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    buf_ptrs = (u8p * nstreams)(*[_as_u8p(b) for b in bufs])

    total = lib.slc_encoded_size(
        n, id_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), nstreams,
        stream_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    out = np.empty(int(total), dtype=np.uint8)
    offsets = np.empty(n, dtype=np.uint64)
    lengths = np.empty(n, dtype=np.uint64)
    written = lib.slc_encode_batch_split(
        n, first_seq, flags, _as_u8p(np.ascontiguousarray(ids_cat)),
        id_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), nstreams,
        buf_ptrs,
        stream_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _as_u8p(out),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    assert written == total
    return out.tobytes(), offsets, lengths


def scan(data: bytes):
    """Recovery scan -> list of (offset, length, seq, flags, rec_id) or None."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    # minimum syntactically valid record is 24 bytes (8B header + 12B empty
    # body + 4B crc), so len//24 bounds the entry count exactly
    max_entries = max(1, len(data) // 24) + 1
    offsets = np.empty(max_entries, np.uint64)
    lengths = np.empty(max_entries, np.uint64)
    seqs = np.empty(max_entries, np.uint64)
    flags = np.empty(max_entries, np.uint8)
    id_offs = np.empty(max_entries, np.uint64)
    id_lens = np.empty(max_entries, np.uint32)
    count = lib.slc_scan(
        _as_u8p(np.ascontiguousarray(arr)), len(data), max_entries,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        id_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        id_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if int(count) >= max_entries:
        # table filled to capacity: the C scan stops early rather than
        # overflow, so trailing records may be missing — use the pure-Python
        # scan instead of silently truncating recovery
        return None
    out = []
    try:
        for i in range(int(count)):
            s, l = int(id_offs[i]), int(id_lens[i])
            out.append((int(offsets[i]), int(lengths[i]), int(seqs[i]),
                        int(flags[i]), data[s:s + l].decode("utf-8")))
    except UnicodeDecodeError:
        # a CRC-colliding corrupt entry with a non-UTF-8 id: fall back to
        # the python scan, which skip-and-resyncs it
        return None
    return out


# ---------------------------------------------------------------------------
# JSON field projector (native/jsonproj.cpp)
# ---------------------------------------------------------------------------

_JP_PATH = os.path.join(os.path.dirname(__file__), "libjsonproj.so")
_jp = None


def _try_build_jp() -> None:
    _build_lib("jsonproj.cpp", _JP_PATH)


def get_jsonproj():
    """ctypes handle for the JSON projector, or None."""
    global _jp
    if _jp is not None:
        return _jp
    if not os.path.exists(_JP_PATH):
        _try_build_jp()
    if not os.path.exists(_JP_PATH):
        return None
    try:
        lib = ctypes.CDLL(_JP_PATH)
    except OSError:
        return None
    lib.jp_extract.restype = None
    lib.jp_extract.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),    # data
        ctypes.POINTER(ctypes.c_uint64),   # starts
        ctypes.POINTER(ctypes.c_uint32),   # lens
        ctypes.c_uint64,                   # n
        ctypes.POINTER(ctypes.c_char_p),   # fields
        ctypes.POINTER(ctypes.c_uint32),   # field_lens
        ctypes.c_uint32,                   # nf
        ctypes.POINTER(ctypes.c_uint8),    # kinds (n, nf)
        ctypes.POINTER(ctypes.c_double),   # nums (n, nf)
        ctypes.POINTER(ctypes.c_int64),    # str_off (n, nf)
        ctypes.POINTER(ctypes.c_int32),    # str_len (n, nf)
        ctypes.POINTER(ctypes.c_uint8),    # row_flags (n,)
    ]
    _jp = lib
    return _jp


def jp_extract(docs: list, fields: list):
    """Project top-level scalar fields out of N JSON documents in one native
    pass.  docs: list of bytes|None (None/empty -> fallback row).

    Returns (kinds (n, nf) u8, nums (n, nf) f64, strs (n, nf) object —
    decoded str or None, row_flags (n,) u8) with flag 1 meaning "python must
    re-parse this row"; returns None when the library is unavailable."""
    lib = get_jsonproj()
    if lib is None:
        return None
    n, nf = len(docs), len(fields)
    blobs = [d if d is not None else b"" for d in docs]
    data = b"".join(blobs)
    lens = np.fromiter((len(b) for b in blobs), dtype=np.uint32, count=n)
    starts = np.zeros(n, dtype=np.uint64)
    np.cumsum(lens[:-1], out=starts[1:])
    kinds = np.zeros((n, nf), dtype=np.uint8)
    nums = np.zeros((n, nf), dtype=np.float64)
    str_off = np.zeros((n, nf), dtype=np.int64)
    str_len = np.zeros((n, nf), dtype=np.int32)
    flags = np.zeros(n, dtype=np.uint8)

    fbytes = [f.encode() for f in fields]
    carr = (ctypes.c_char_p * nf)(*fbytes)
    flens = np.fromiter((len(f) for f in fbytes), dtype=np.uint32, count=nf)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jp_extract(
        ctypes.cast(ctypes.c_char_p(data), u8p),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, carr,
        flens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nf,
        kinds.ctypes.data_as(u8p),
        nums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        str_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        str_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flags.ctypes.data_as(u8p),
    )

    # decode strings: plain ones slice straight out of the buffer; ones with
    # escapes (str_len == -1) force the row through the python fallback
    strs = np.empty((n, nf), dtype=object)
    esc_rows = (kinds == 2) & (str_len < 0)
    if esc_rows.any():
        flags[np.any(esc_rows, axis=1)] = 1
    rs, fs = np.nonzero((kinds == 2) & (str_len >= 0))
    for r, f in zip(rs.tolist(), fs.tolist()):
        o = str_off[r, f]
        try:
            strs[r, f] = data[o:o + str_len[r, f]].decode("utf-8")
        except UnicodeDecodeError:
            flags[r] = 1
    return kinds, nums, strs, flags

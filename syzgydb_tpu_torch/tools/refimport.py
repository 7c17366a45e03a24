"""Read-only importer for SyzgyDB Go span files (.dat), the port's
counterpart of ``syzgydb_tpu/tools/refimport.py``.

The migration path for existing SyzgyDB deployments: parse the Go
span-file grammar directly (no Go toolchain needed) and add every live
record to a collection of the port, on the device the caller names.  The
grammar (spanfile.go:1-22, serializeSpan 679-728, parseSpan 730-817,
scanFile 282-357):

    Span ::= MagicNumber(4, big-endian: 'SPAN' active / 'FREE' free)
             SpanLength(4, big-endian uint32 — TOTAL span bytes incl.
                        magic, length, padding and checksum)
             SequenceNumber(7code)  RecordIDLength(7code)  RecordID(...)
             DataStreamCount(1)
             DataStream* ::= StreamID(1) StreamLength(7code) Data(...)
             Padding(varies)  Checksum(4, big-endian CRC32-IEEE of the
                        span bytes MINUS the trailing 4 checksum bytes)

Scan semantics follow scanFile: magic 0 ends the scan (the rest of the
file is free space), FREE spans are skipped by their length field,
corrupt or CRC-failing spans are skipped by length, and the HIGHEST
sequence number wins per record ID (duplicate spans are superseded
versions).  Record ID "" holds the collection-options JSON
(collection.go:258-272); data records store metadata JSON as stream 0 and
the quantized vector as stream 1 (collection.go:446-449), both in the
bit-exact codec of ops/quantize (quantization.go:5-36, encodeDocument
collection.go:713-744: big-endian, high-nibble-first 4-bit).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from ..core.collection import COSINE, EUCLIDEAN, Collection, CollectionOptions
from ..ops import quantize as qz

ACTIVE_MAGIC = 0x5350414E  # 'SPAN'
FREE_MAGIC = 0x46524545    # 'FREE'
_MIN_SPAN = 12             # minSpanLength (spanfile.go:21): 4+1+1+1+1+4


class RefSpan:
    __slots__ = ("seq", "record_id", "streams")

    def __init__(self, seq: int, record_id: str, streams: dict[int, bytes]):
        self.seq = seq
        self.record_id = record_id
        self.streams = streams


def _read_7code(data: bytes, at: int) -> tuple[int, int]:
    """Big-endian base-128 varint, continuation bit 0x80 (read7Code,
    spanfile.go:627-636)."""
    result = 0
    while at < len(data):
        d = data[at]
        result = (result << 7) | (d & 0x7F)
        at += 1
        if not (d & 0x80):
            return result, at
    raise ValueError("buffer too short to read 7code")


def _parse_span(data: bytes) -> RefSpan:
    """parseSpan (spanfile.go:730-817) for one CRC-verified active span."""
    seq, at = _read_7code(data, 8)
    id_len, at = _read_7code(data, at)
    record_id = data[at:at + id_len].decode()
    at += id_len
    n_streams = data[at]
    at += 1
    streams: dict[int, bytes] = {}
    for _ in range(n_streams):
        if at >= len(data):
            raise ValueError("data too short to contain all streams")
        sid = data[at]
        at += 1
        slen, at = _read_7code(data, at)
        if at + slen > len(data):
            raise ValueError("data too short for stream data")
        streams[sid] = data[at:at + slen]
        at += slen
    return RefSpan(seq, record_id, streams)


def scan_ref_spans(data: bytes) -> Iterator[RefSpan]:
    """Walk raw span-file bytes, yielding every CRC-valid active span in
    file order (the caller applies highest-seq-wins).  Tolerant as scanFile
    is (spanfile.go:282-357): zero magic ends the file, FREE and corrupt
    spans are skipped by their length field."""
    offset, size = 0, len(data)
    while offset + _MIN_SPAN <= size:
        magic = struct.unpack_from(">I", data, offset)[0]
        if magic == 0:
            return
        length = struct.unpack_from(">I", data, offset + 4)[0]
        if length == 0:
            return  # scanFile errors here; an import stops tolerantly
        if offset + length > size:
            return
        if magic == ACTIVE_MAGIC and length >= _MIN_SPAN:
            # length < _MIN_SPAN: a corrupt header too short to hold a
            # checksum, skipped by length like any other corrupt span
            span_bytes = data[offset:offset + length]
            want = struct.unpack_from(">I", span_bytes, length - 4)[0]
            if zlib.crc32(span_bytes[:-4]) == want:
                try:
                    yield _parse_span(span_bytes)
                except (ValueError, IndexError, UnicodeDecodeError):
                    pass  # skip an unparseable span, keep scanning
        # FREE / corrupt / unknown magic: skip by length
        offset += length


def read_ref_file(path: str) -> tuple[dict, list[RefSpan]]:
    """Parse a Go .dat: (collection options dict, live data spans).

    Live = highest sequence number per record ID (scanFile semantics),
    ordered by the decimal-string record ID; record "" (the options span)
    is returned separately."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 4:
        magic = struct.unpack_from(">I", data, 0)[0]
        if magic not in (ACTIVE_MAGIC, FREE_MAGIC):
            raise ValueError(f"not a reference span file: bad magic "
                             f"0x{magic:08x}")
    best: dict[str, RefSpan] = {}
    for span in scan_ref_spans(data):
        cur = best.get(span.record_id)
        if cur is None or span.seq > cur.seq:
            best[span.record_id] = span
    opts_span = best.pop("", None)
    options: dict = {}
    if opts_span is not None and 0 in opts_span.streams:
        try:
            options = json.loads(opts_span.streams[0])
        except (json.JSONDecodeError, UnicodeDecodeError):
            options = {}
    return options, sorted(best.values(), key=lambda s: s.record_id)


# the Go DistanceMethod constants (collection.go:51-56) equal the port's
# (EUCLIDEAN=0, COSINE=1); checked at import so drift cannot silently flip
# the metric of migrated data
assert (EUCLIDEAN, COSINE) == (0, 1)


def import_ref_file(dat_path: str, collection_name: str,
                    batch_rows: int = 10_000,
                    options_override: Optional[dict] = None,
                    device=None) -> Collection:
    """Create a collection of the port from a Go .dat on `device` (CUDA
    unless the caller asks for the CPU).  The source file is only read.

    Vector bytes re-enter through the bit-exact codec, so quantized values
    round-trip identically.  Metadata stream 0 is carried verbatim."""
    ref_opts, spans = read_ref_file(dat_path)
    dims = int(ref_opts.get("dimension_count", 0))
    quant = int(ref_opts.get("quantization", 64)) or 64
    if dims <= 0:
        # options span missing or corrupt: infer dims from the first vector
        for s in spans:
            if 1 in s.streams:
                vb = len(s.streams[1])
                dims = {4: vb * 2, 8: vb, 16: vb // 2,
                        32: vb // 4, 64: vb // 8}[quant]
                break
        if dims <= 0:
            raise ValueError("cannot determine dimension_count from "
                             f"{dat_path} (no options span, no records)")
    options = CollectionOptions(
        name=collection_name,
        distance_method=int(ref_opts.get("distance_method", 0)),
        dimension_count=dims,
        quantization=quant,
        create_and_overwrite=True,
    )
    if options_override:
        for key, val in options_override.items():
            setattr(options, key, val)
    coll = Collection(options, device=device)
    ids: list[int] = []
    vecs: list[np.ndarray] = []
    metas: list[bytes] = []

    def flush():
        if ids:
            coll.add_documents(ids, np.stack(vecs), metas)
            ids.clear(); vecs.clear(); metas.clear()

    for span in spans:
        try:
            doc_id = int(span.record_id)
        except ValueError:
            continue  # non-numeric IDs cannot exist through the Go API
        vec_bytes = span.streams.get(1)
        if vec_bytes is None or \
                len(vec_bytes) != qz.vector_byte_size(quant, dims):
            continue  # wrong-shape record (foreign or corrupt): skip
        ids.append(doc_id)
        vecs.append(qz.unpack_vector(vec_bytes, dims, quant))
        metas.append(bytes(span.streams.get(0, b"")))
        if len(ids) >= batch_rows:
            flush()
    flush()
    return coll


# ---------------------------------------------------------------------------
# Byte-level writer of serializeSpan (spanfile.go:679-728): fixture
# machinery, so tests and the GPU smoke run can build real Go span files
# without the Go toolchain.  Not a production write path: the port never
# writes .dat files.
# ---------------------------------------------------------------------------

def _write_7code(n: int) -> bytes:
    out = bytearray()
    groups = []
    while True:
        groups.append(n & 0x7F)
        n >>= 7
        if n == 0:
            break
    for i, g in enumerate(reversed(groups)):
        out.append(g | (0x80 if i < len(groups) - 1 else 0))
    return bytes(out)


def build_ref_span(seq: int, record_id: str,
                   streams: list[tuple[int, bytes]],
                   magic: int = ACTIVE_MAGIC, pad: int = 0) -> bytes:
    """Serialize one span (serializeSpan and WriteRecord's checksum append,
    spanfile.go:679-728, 413-438).  `pad` emulates the in-span padding
    WriteRecord inserts for sub-minSpanLength remainders."""
    rid = record_id.encode()
    body = bytearray()
    body += _write_7code(seq)
    body += _write_7code(len(rid))
    body += rid
    body.append(len(streams))
    for sid, payload in streams:
        body.append(sid)
        body += _write_7code(len(payload))
        body += payload
    length = 4 + 4 + len(body) + pad + 4
    span = struct.pack(">II", magic, length) + bytes(body) + b"\0" * pad
    return span + struct.pack(">I", zlib.crc32(span))


def build_ref_file(options: dict,
                   records: list[tuple[int, np.ndarray, bytes]],
                   quantization: int, free_gaps: bool = False) -> bytes:
    """Assemble a whole .dat image: the options span (record "", seq 0)
    followed by one span per (id, vector, metadata) record, with optional
    FREE spans between them (allocateSpan leaves those)."""
    out = bytearray()
    out += build_ref_span(0, "", [(0, json.dumps(options).encode())])
    seq = 1
    for doc_id, vec, meta in records:
        packed = qz.pack_vector(np.asarray(vec, dtype=np.float64),
                                quantization)
        out += build_ref_span(seq, str(doc_id), [(0, meta), (1, packed)])
        seq += 1
        if free_gaps:
            gap = 16
            out += struct.pack(">II", FREE_MAGIC, gap) + b"\0" * (gap - 8)
    return bytes(out)

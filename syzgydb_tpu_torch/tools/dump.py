"""Dump, export and import tools of the port (the counterpart of
``syzgydb_tpu/tools/dump.py``; SyzgyDB Go: dump.go).

* dump_index(path): walks the raw span-log bytes and prints every record's
  fields — the storage debugging tool (dump.go:220-318, for this log
  format).
* export_json(collection, writer): streams
  {"collection": <options>, "records": [{id, vector, metadata}]}
  (dump.go:48-136).  With compact=True the vectors are base64 of the packed
  storage bytes.
* import_json(collection_name, reader): recreates the collection from an
  export stream (dump.go:138-217), on the device the caller names.

The output text is byte-identical to the JAX package's for the same
collection file, and an export written by either package imports into the
other.  Export reads the span log through Collection.iter_export_rows and
launches no kernel.
"""

from __future__ import annotations

import base64
import json
import struct
import sys
import zlib
from typing import IO

import numpy as np

from ..core import storage
from ..core.collection import Collection, CollectionOptions
from ..ops import quantize as qz


def dump_index(path: str, out: IO[str] | None = None) -> None:
    out = out if out is not None else sys.stdout
    with open(path, "rb") as f:
        data = f.read()
    out.write(f"File: {path} ({len(data)} bytes)\n")
    if data[:4] != storage.FILE_MAGIC:
        out.write("  !! bad file magic\n")
        return
    (version,) = struct.unpack_from("<I", data, 4)
    out.write(f"  magic=SYZL version={version}\n")
    pos = storage._HDR.size
    i = 0
    while pos + storage._REC_HDR.size <= len(data):
        magic, body_len = storage._REC_HDR.unpack_from(data, pos)
        end = pos + storage._REC_HDR.size + body_len + 4
        if magic != storage.REC_MAGIC or end > len(data):
            nxt = data.find(storage.REC_MAGIC, pos + 1)
            out.write(f"  [{i}] offset={pos} CORRUPT (resync to "
                      f"{nxt if nxt != -1 else 'EOF'})\n")
            if nxt == -1:
                break
            pos = nxt
            continue
        body = data[pos + storage._REC_HDR.size:end - 4]
        (crc,) = struct.unpack_from("<I", data, end - 4)
        crc_ok = zlib.crc32(body) == crc
        seq, flags, rec_id, streams = storage._decode_body(body)
        kind = "TOMBSTONE" if flags & 1 else "RECORD"
        out.write(f"  [{i}] offset={pos} len={end - pos} {kind} seq={seq} "
                  f"id={rec_id!r} streams={[len(s) for s in streams]} "
                  f"crc={'ok' if crc_ok else 'BAD'}\n")
        pos = end
        i += 1


# compact-export marker written into the exported options object (not the
# stored collection options): vectors are the span log's packed storage
# bytes (big-endian codes, high-nibble-first 4-bit), base64'd per record.
# A restore skips float parsing and requantization, so the storage comes
# back bit-identical by construction.
VECTOR_ENCODING_PACKED = "packed+b64"


def export_json(collection: Collection, out: IO[str],
                compact: bool = False) -> None:
    opts = collection.options
    copts = json.loads(opts.to_json())
    if compact:
        copts["vector_encoding"] = VECTOR_ENCODING_PACKED
    out.write("{\n  \"collection\": ")
    json.dump(copts, out, indent=2)
    out.write(",\n  \"records\": [")
    q, dims = collection.quantization, collection.dimension_count
    if compact:
        first = True
        for ids, rows, metas in collection.iter_export_rows(raw=True):
            if rows.shape[1] % 3 == 0:
                # one base64 of the whole chunk sliced into per-row texts:
                # each row's byte count is a multiple of 3, so no base64
                # group straddles two rows
                enc = base64.b64encode(np.ascontiguousarray(rows)).decode()
                step = rows.shape[1] // 3 * 4
                texts = [enc[j * step:(j + 1) * step]
                         for j in range(len(ids))]
            else:
                texts = [base64.b64encode(rows[j].tobytes()).decode()
                         for j in range(len(ids))]
            for j, doc_id in enumerate(ids):
                out.write("," if not first else "")
                first = False
                md = metas[j]
                out.write(
                    "\n    {\"id\": %d, \"vector\": \"%s\", "
                    "\"metadata\": %s}" % (
                        doc_id, texts[j], md.decode() if md else "null"))
        out.write("\n  ]\n}\n")
        return
    first = True
    tab = _code_texts(q) if q <= 16 else None
    for ids, rows, metas in collection.iter_export_rows(raw=tab is not None):
        if tab is not None:
            # quantized values come from a 2^q-sized alphabet: render each
            # code's JSON text once, then each vector is a gather and a
            # join.  "[" + ", ".join(...) + "]" is exactly json.dumps' list
            # format, so the text is the per-value path's
            if q == 8:
                codes = rows
            elif q == 16:
                codes = rows.view(">u2")
            else:  # 4-bit: unpack nibbles, drop the odd-dims pad
                codes = np.empty((rows.shape[0], 2 * rows.shape[1]),
                                 dtype=np.uint8)
                codes[:, 0::2] = rows >> 4
                codes[:, 1::2] = rows & 0x0F
                codes = codes[:, :dims]
            texts = tab[codes]
        for j, doc_id in enumerate(ids):
            out.write("," if not first else "")
            first = False
            md = metas[j]
            vec_text = "[" + ", ".join(texts[j].tolist()) + "]" \
                if tab is not None else json.dumps(rows[j].tolist())
            out.write("\n    {\"id\": %d, \"vector\": %s, \"metadata\": %s}" % (
                doc_id, vec_text, md.decode() if md else "null"))
    out.write("\n  ]\n}\n")


_CODE_TEXTS: dict[int, np.ndarray] = {}


def _code_texts(bits: int) -> np.ndarray:
    """json.dumps text of every dequantized code value (object array)."""
    tab = _CODE_TEXTS.get(bits)
    if tab is None:
        codes = np.arange(1 << bits, dtype=np.uint64)
        vals = qz.dequantize_np(codes, bits)
        tab = _CODE_TEXTS[bits] = np.array(
            [json.dumps(float(v)) for v in vals], dtype=object)
    return tab


class _JSONStream:
    """Incremental JSON value reader over a text stream (the reference's
    json.Decoder token loop, dump.go:138-217): values are decoded one at a
    time from a bounded sliding buffer, so a multi-GB export never sits in
    memory — only the options object and one record at a time."""

    _CHUNK = 1 << 16

    def __init__(self, reader: IO[str]):
        self._reader = reader
        self._buf = ""
        self._eof = False
        self._decoder = json.JSONDecoder()

    def _fill(self) -> bool:
        chunk = self._reader.read(self._CHUNK)
        if not chunk:
            self._eof = True
            return False
        self._buf += chunk
        return True

    def skip_ws(self) -> None:
        while True:
            self._buf = self._buf.lstrip()
            if self._buf or not self._fill():
                return

    def peek(self) -> str:
        self.skip_ws()
        return self._buf[:1]

    def expect(self, ch: str) -> None:
        self.skip_ws()
        if not self._buf.startswith(ch):
            raise ValueError(
                f"malformed export stream: expected {ch!r}, got "
                f"{self._buf[:20]!r}")
        self._buf = self._buf[1:]

    def value(self):
        """Decode one JSON value from the head of the stream."""
        self.skip_ws()
        while True:
            try:
                val, end = self._decoder.raw_decode(self._buf)
                self._buf = self._buf[end:]
                return val
            except json.JSONDecodeError:
                # could be an incomplete tail: read more unless at EOF
                if not self._fill():
                    raise


def import_json(collection_name: str, reader: IO[str],
                batch_rows: int = 10_000, device=None) -> Collection:
    """Recreate a collection from an export stream (dump.go:138-217) on
    `device` (CUDA unless the caller asks for the CPU).

    Records are decoded incrementally and fed to add_documents (or, for a
    compact export, add_documents_packed) in `batch_rows` chunks, so an
    import of any size runs at bounded memory.  Each chunk passes the
    collection's capacity preflight before it is written."""
    stream = _JSONStream(reader)
    stream.expect("{")
    key = stream.value()
    if key != "collection":
        raise ValueError("export stream missing 'collection' options")
    stream.expect(":")
    copts = stream.value()
    encoding = copts.pop("vector_encoding", None)
    if encoding not in (None, VECTOR_ENCODING_PACKED):
        raise ValueError(f"unknown vector_encoding {encoding!r}")
    options = CollectionOptions(
        name=collection_name,
        distance_method=int(copts.get("distance_method", 0)),
        dimension_count=int(copts.get("dimension_count", 0)),
        quantization=int(copts.get("quantization", 64)),
        create_and_overwrite=True,
    )
    for extra in ("index_tables", "index_bits_per_table", "search_budget",
                  "index_seed"):
        if extra in copts:
            setattr(options, extra, copts[extra])
    collection = Collection(options, device=device)

    ids: list[int] = []
    vecs: list = []
    metas: list[bytes] = []
    packed = encoding == VECTOR_ENCODING_PACKED
    if packed:
        row_bytes = qz.vector_byte_size(options.quantization,
                                        options.dimension_count)

    def flush() -> None:
        if not ids:
            return
        if packed:
            if row_bytes % 3 == 0:
                # padding-free per-row base64: one decode of the joined
                # batch (the export's chunk encode, reversed)
                raw = base64.b64decode("".join(vecs).encode(),
                                       validate=True)
            else:
                raw = b"".join(base64.b64decode(v, validate=True)
                               for v in vecs)
            rows = np.frombuffer(raw, dtype=np.uint8)
            if rows.size != len(ids) * row_bytes:
                raise ValueError(
                    "compact export vector payload has the wrong size")
            collection.add_documents_packed(
                ids, rows.reshape(len(ids), row_bytes), metas)
        else:
            collection.add_documents(ids, vecs, metas)
        ids.clear(); vecs.clear(); metas.clear()

    if stream.peek() == ",":
        stream.expect(",")
        key = stream.value()
        if key != "records":
            raise ValueError(f"unexpected export key {key!r}")
        stream.expect(":")
        stream.expect("[")
        if stream.peek() == "]":
            stream.expect("]")
        else:
            while True:
                rec = stream.value()
                ids.append(int(rec["id"]))
                vecs.append(rec["vector"])
                metas.append(json.dumps(rec.get("metadata")).encode())
                if len(ids) >= batch_rows:
                    flush()
                nxt = stream.peek()
                if nxt == ",":
                    stream.expect(",")
                    continue
                stream.expect("]")
                break
    flush()
    return collection

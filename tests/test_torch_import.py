"""The port's streaming JSON import and Go .dat migration
(syzgydb_tpu_torch/tools/dump.import_json and tools/refimport.py) against
the JAX package's, on the CPU.

Each case of tests/test_import.py runs on the port and on the JAX package
with the same inputs (made from a seed with numpy, or built byte by byte
with the span writer); the imported collections must hold equal ids,
metadata and packed storage bytes — exact, since the codec is bit-exact.
The port's span writer must write the JAX writer's bytes."""

import io
import json
import resource

import numpy as np
import pytest

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.tools import dump as jdump
from syzgydb_tpu.tools import refimport as jref
from syzgydb_tpu_torch.ops import quantize as qz
from syzgydb_tpu_torch.tools import cli as tcli
from syzgydb_tpu_torch.tools import dump as tdump
from syzgydb_tpu_torch.tools import refimport as tref

CPU = {"device": "cpu"}


class _LazyExportReader(io.TextIOBase):
    """Synthesizes a big export stream record by record, so the test never
    holds it whole either: import reads it like a file."""

    def __init__(self, n_records: int, dims: int, quant: int):
        self._gen = self._chunks(n_records, dims, quant)
        self._buf = ""

    @staticmethod
    def _chunks(n, dims, quant):
        yield ('{\n  "collection": ' + json.dumps(
            {"name": "big", "distance_method": 1, "dimension_count": dims,
             "quantization": quant, "index_seed": 3}) + ',\n  "records": [')
        for i in range(n):
            vec = [((i * 31 + j * 7) % 200 - 100) / 100.0
                   for j in range(dims)]
            yield ("," if i else "") + json.dumps(
                {"id": i, "vector": vec, "metadata": {"i": i}})
        yield "]\n}\n"

    def read(self, size=-1):
        while size < 0 or len(self._buf) < size:
            nxt = next(self._gen, None)
            if nxt is None:
                break
            self._buf += nxt
        if size < 0:
            out, self._buf = self._buf, ""
        else:
            out, self._buf = self._buf[:size], self._buf[size:]
        return out


def _rows(coll) -> tuple:
    """(ids, packed storage rows, metadata) of every live record, in
    ascending id order."""
    ids, rows, metas = [], [], []
    for i, r, m in coll.iter_export_rows(raw=True):
        ids += i
        rows.append(r)
        metas += [bytes(x) for x in m]
    return ids, (np.concatenate(rows) if rows else None), metas


def _same(a, b) -> None:
    ia, ra, ma = _rows(a)
    ib, rb, mb = _rows(b)
    assert ia == ib and ma == mb
    np.testing.assert_array_equal(ra, rb)
    assert (a.dimension_count, a.quantization, a.metric) == \
        (b.dimension_count, b.quantization, b.metric)


def test_streaming_import_bounded_rss(tmp_path):
    """A 100k-row import runs at bounded peak RSS: a whole-document
    json.load of this stream would hold ~500 MB, the streaming reader one
    10k-row chunk.  The JAX package's import of the same stream stores the
    same bytes."""
    n, dims, quant = 100_000, 8, 8
    rss_before_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    coll = tdump.import_json(str(tmp_path / "big.dat"),
                             _LazyExportReader(n, dims, quant), device="cpu")
    rss_after_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    ref = jdump.import_json(str(tmp_path / "big_jax.dat"),
                            _LazyExportReader(n, dims, quant))
    try:
        assert coll.get_document_count() == n
        for i in (0, 1, n // 2, n - 1):
            doc = coll.get_document(i)
            vec = np.array([((i * 31 + j * 7) % 200 - 100) / 100.0
                            for j in range(dims)])
            np.testing.assert_allclose(
                doc.vector, qz.quantization_roundtrip(vec[None], quant)[0],
                atol=1e-12)
            assert json.loads(doc.metadata) == {"i": i}
        # ru_maxrss is monotone: earlier tests in the process can only
        # make this check stricter
        assert rss_after_kb - rss_before_kb < 200_000, (
            rss_before_kb, rss_after_kb)
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()


@pytest.mark.parametrize("db", [jdb, tdb], ids=["jax", "torch"])
def test_streaming_import_chunked_adds(tmp_path, monkeypatch, db):
    """Records are fed to add_documents in bounded chunks, the same chunks
    in both packages."""
    calls = []
    orig = db.Collection.add_documents

    def spy(self, ids, vecs, metas):
        calls.append(len(ids))
        return orig(self, ids, vecs, metas)

    monkeypatch.setattr(db.Collection, "add_documents", spy)
    dump = tdump if db is tdb else jdump
    coll = dump.import_json(str(tmp_path / "c.dat"),
                            _LazyExportReader(2_500, 4, 64), batch_rows=1000,
                            **(CPU if db is tdb else {}))
    coll.close()
    assert calls == [1000, 1000, 500]


@pytest.mark.parametrize("dump", [jdump, tdump], ids=["jax", "torch"])
def test_streaming_import_malformed(tmp_path, dump):
    kw = CPU if dump is tdump else {}
    with pytest.raises(ValueError, match="collection"):
        dump.import_json(str(tmp_path / "x.dat"),
                         io.StringIO('{"records": []}'), **kw)
    with pytest.raises(ValueError, match="unexpected export key"):
        dump.import_json(str(tmp_path / "z.dat"), io.StringIO(
            '{"collection": {"dimension_count": 2}, "rows": []}'), **kw)
    with pytest.raises(json.JSONDecodeError):
        dump.import_json(str(tmp_path / "y.dat"),
                         io.StringIO('{"collection": {"dimension_count": 2}, '
                                     '"records": [{"id": 0, "vector": [0, 1'),
                         **kw)


def test_streaming_import_empty_records(tmp_path):
    text = ('{"collection": {"dimension_count": 3, "quantization": 8},'
            ' "records": []}')
    coll = tdump.import_json(str(tmp_path / "e.dat"), io.StringIO(text),
                             device="cpu")
    ref = jdump.import_json(str(tmp_path / "e_jax.dat"), io.StringIO(text))
    try:
        assert coll.get_document_count() == 0
        assert coll.quantization == 8
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()


# ---------------------------------------------------------------------------
# Go .dat migration
# ---------------------------------------------------------------------------

def _ref_options(dims, quant, metric=tdb.EUCLIDEAN):
    # the shape of the Go collection's stored options JSON
    # (collection.go:258-272)
    return {"name": "ref.dat", "distance_method": int(metric),
            "dimension_count": dims, "quantization": quant}


def _import_both(tmp_path, dat):
    """The port's and the JAX package's import of one .dat."""
    return (tref.import_ref_file(str(dat), str(tmp_path / "n.dat"),
                                 device="cpu"),
            jref.import_ref_file(str(dat), str(tmp_path / "n_jax.dat")))


@pytest.mark.parametrize("quant", [64, 8])
def test_import_ref_roundtrip(tmp_path, rng, quant):
    """A fixture .dat built by the byte-level serializeSpan writer."""
    dims = 6
    records = [(i, rng.uniform(-1, 1, size=dims),
                json.dumps({"i": i}).encode()) for i in range(20)]
    blob = tref.build_ref_file(_ref_options(dims, quant), records, quant,
                               free_gaps=True)
    dat = tmp_path / "ref.dat"
    dat.write_bytes(blob)

    coll, ref = _import_both(tmp_path, dat)
    try:
        assert coll.get_document_count() == 20
        assert coll.quantization == quant
        assert coll.metric == "euclidean"
        for i, vec, meta in records:
            doc = coll.get_document(i)
            np.testing.assert_allclose(
                doc.vector, qz.quantization_roundtrip(
                    np.asarray(vec)[None], quant)[0], atol=0)
            assert doc.metadata == meta
        _same(coll, ref)
        # imported data is searchable
        res = coll.search(tdb.SearchArgs(vector=records[3][1], k=1,
                                         precision="exact"))
        assert res.results[0].id == 3
    finally:
        coll.close()
        ref.close()


def _superseded_and_corrupt() -> tuple[bytes, np.ndarray]:
    dims, quant = 4, 8
    v_old = np.array([0.1, 0.2, 0.3, 0.4])
    v_new = np.array([-0.5, 0.5, -0.5, 0.5])
    out = bytearray()
    out += tref.build_ref_span(
        0, "", [(0, json.dumps(_ref_options(dims, quant)).encode())])
    out += tref.build_ref_span(
        1, "7", [(0, b'{"v": "old"}'), (1, qz.pack_vector(v_old, quant))])
    # corrupt span: valid length, bad CRC — skipped, not resynced
    bad = bytearray(tref.build_ref_span(
        2, "8", [(0, b"{}"), (1, qz.pack_vector(v_old, quant))]))
    bad[-1] ^= 0xFF
    out += bad
    # a span too short to hold its checksum, skipped by length
    out += tref.build_ref_span(0, "", [])[:4] + (11).to_bytes(4, "big") + \
        b"\0" * 3
    # superseding version of record 7 (higher seq)
    out += tref.build_ref_span(
        5, "7", [(0, b'{"v": "new"}'), (1, qz.pack_vector(v_new, quant))])
    # zero-magic tail = free space to EOF
    out += b"\0" * 64
    return bytes(out), v_new


def test_import_ref_superseding_and_corruption(tmp_path):
    """Highest seq wins per ID; CRC-corrupt spans are skipped by length;
    a zero-magic tail ends the scan (scanFile semantics)."""
    blob, v_new = _superseded_and_corrupt()
    dat = tmp_path / "ref2.dat"
    dat.write_bytes(blob)
    coll, ref = _import_both(tmp_path, dat)
    try:
        assert sorted(coll.get_all_ids()) == [7]
        doc = coll.get_document(7)
        assert doc.metadata == b'{"v": "new"}'
        np.testing.assert_allclose(
            doc.vector, qz.quantization_roundtrip(v_new[None], 8)[0],
            atol=0)
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()
    # the reader itself: the same live spans, in the same order
    got = [(s.seq, s.record_id, s.streams) for s in
           tref.scan_ref_spans(blob)]
    want = [(s.seq, s.record_id, s.streams) for s in
            jref.scan_ref_spans(blob)]
    assert got == want and [g[:2] for g in got] == [(0, ""), (1, "7"),
                                                    (5, "7")]


def test_import_ref_no_options_span(tmp_path):
    """Missing options record: the dimension is inferred from the first
    vector."""
    v = np.array([0.1, -0.2, 0.3, -0.4, 0.5])
    out = tref.build_ref_span(
        1, "1", [(0, b"null"), (1, qz.pack_vector(v, 64))])
    dat = tmp_path / "ref3.dat"
    dat.write_bytes(out)
    coll, ref = _import_both(tmp_path, dat)
    try:
        assert coll.dimension_count == 5
        np.testing.assert_allclose(coll.get_document(1).vector, v, atol=0)
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()
    empty = tmp_path / "ref4.dat"
    empty.write_bytes(tref.build_ref_span(1, "x", [(0, b"{}")]))
    for mod in (tref, jref):
        with pytest.raises(ValueError, match="dimension_count"):
            mod.import_ref_file(str(empty), str(tmp_path / "n5.dat"),
                                **(CPU if mod is tref else {}))


def test_import_ref_bad_magic(tmp_path):
    dat = tmp_path / "junk.dat"
    dat.write_bytes(b"JUNKJUNKJUNKJUNK")
    for mod in (tref, jref):
        with pytest.raises(ValueError, match="bad magic"):
            mod.import_ref_file(str(dat), str(tmp_path / "n4.dat"),
                                **(CPU if mod is tref else {}))


def test_cli_import_ref(tmp_path, capsys, monkeypatch):
    from syzgydb_tpu_torch.server import config as tcfg
    monkeypatch.setattr(tcfg, "global_config", tcfg.global_config)
    dims, quant = 3, 8
    records = [(1, np.array([0.1, 0.2, 0.3]), b'{"x": 1}')]
    dat = tmp_path / "r.dat"
    dat.write_bytes(tref.build_ref_file(
        _ref_options(dims, quant, tdb.COSINE), records, quant))
    dst = str(tmp_path / "out.dat")
    assert tcli.main(["--import-ref", str(dat), "--output", dst,
                      "--platform", "cpu",
                      "--data-folder", str(tmp_path)]) == 0
    assert "Imported 1 records" in capsys.readouterr().out
    coll = tdb.Collection(tdb.CollectionOptions(name=dst,
                                                dimension_count=dims),
                          device="cpu")
    ref = jdb.Collection(jdb.CollectionOptions(name=dst,
                                               dimension_count=dims))
    try:
        assert coll.get_document_count() == 1
        assert coll.metric == "cosine"
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()


@pytest.mark.parametrize("free_gaps", [False, True])
@pytest.mark.parametrize("quant", [4, 8, 16, 32, 64])
def test_build_ref_file_bytes_match_the_jax_writer(rng, quant, free_gaps):
    dims = 5
    records = [(int(i), rng.uniform(-1, 1, dims),
                json.dumps({"i": int(i)}).encode())
               for i in rng.integers(0, 2**40, 12)]
    opts = _ref_options(dims, quant, tdb.COSINE)
    assert tref.build_ref_file(opts, records, quant, free_gaps) == \
        jref.build_ref_file(opts, records, quant, free_gaps)
    for seq, pad in ((0, 0), (300, 3), (2**30, 17)):
        assert tref.build_ref_span(seq, "42", [(1, b"ab")], pad=pad) == \
            jref.build_ref_span(seq, "42", [(1, b"ab")], pad=pad)
    assert tref.build_ref_span(1, "9", [], magic=tref.FREE_MAGIC) == \
        jref.build_ref_span(1, "9", [], magic=jref.FREE_MAGIC)


@pytest.mark.parametrize("quant", [4, 16, 32])
def test_import_ref_equal_in_both_packages(tmp_path, rng, quant):
    """One .dat with superseded versions, a foreign-shaped record and a
    non-numeric id imports into equal collections in both packages, with
    read_ref_file's spans equal too."""
    dims = 7
    records = [(i, rng.uniform(-1, 1, dims), json.dumps({"i": i}).encode())
               for i in (5, 10, 100, 2**63 + 1, 3)]
    blob = bytearray(tref.build_ref_file(_ref_options(dims, quant),
                                         records, quant, free_gaps=True))
    blob += tref.build_ref_span(90, "10", [
        (0, b'{"i": "ten"}'),
        (1, qz.pack_vector(rng.uniform(-1, 1, dims), quant))])
    blob += tref.build_ref_span(91, "11", [(0, b"{}"), (1, b"\x01")])
    blob += tref.build_ref_span(92, "name", [
        (0, b"{}"), (1, qz.pack_vector(np.zeros(dims), quant))])
    dat = tmp_path / "mix.dat"
    dat.write_bytes(bytes(blob))
    (o1, s1), (o2, s2) = tref.read_ref_file(str(dat)), \
        jref.read_ref_file(str(dat))
    assert o1 == o2
    assert [(s.seq, s.record_id, s.streams) for s in s1] == \
        [(s.seq, s.record_id, s.streams) for s in s2]
    coll, ref = _import_both(tmp_path, dat)
    try:
        assert coll.get_all_ids() == [3, 5, 10, 100, 2**63 + 1]
        assert coll.get_document(10).metadata == b'{"i": "ten"}'
        _same(coll, ref)
    finally:
        coll.close()
        ref.close()

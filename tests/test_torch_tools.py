"""The port's tools (syzgydb_tpu_torch/tools/dump.py and the CLI's --dump,
--export and --import) against the JAX package's, on the CPU.

Each case of tests/test_tools.py runs on the port with inputs made from a
seed with numpy, and the port's output is held against the JAX package's
on the same inputs.  The tolerance is exact throughout: the export text,
the dump text, the packed storage bytes and the codes are equal, because
the codec is bit-exact and both packages write one span-log format.  The
cross-package cases open one collection file in both packages, and import
an export written by either package into the other."""

import io
import json
import threading

import numpy as np
import pytest
import torch

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.tools import dump as jdump
from syzgydb_tpu_torch.tools import cli as tcli
from syzgydb_tpu_torch.tools import dump as tdump

CPU = {"device": "cpu"}
PKGS = {"jax": (jdb, jdump, {}), "torch": (tdb, tdump, CPU)}


def _open(pkg, path, dims, **opts):
    db, _, kw = PKGS[pkg]
    return db.Collection(db.CollectionOptions(
        name=str(path), dimension_count=dims, **opts), **kw)


def _build(pkg, path, quant, vecs, metas, ids=None, **opts):
    c = _open(pkg, path, vecs.shape[1], distance_method=jdb.COSINE,
              quantization=quant, create_and_overwrite=True, index_seed=5,
              **opts)
    c.add_documents(list(range(len(vecs))) if ids is None else ids, vecs,
                    metas)
    return c


def _both(tmp_path, quant, vecs, metas, ids=None, name="src.dat", **opts):
    """The same inserts in a collection of each package; one file name in
    two folders, since the name is in the exported options."""
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        out[pkg] = _build(pkg, tmp_path / pkg / name, quant, vecs, metas,
                          ids, **opts)
    return out


def _export(pkg, coll, compact=False) -> str:
    buf = io.StringIO()
    PKGS[pkg][1].export_json(coll, buf, compact=compact)
    return buf.getvalue()


def _stored(coll) -> dict:
    """Every live record's (metadata bytes, packed vector bytes)."""
    return {i: tuple(bytes(s) for s in coll.spanlog.read(str(i)))
            for i in coll.get_all_ids()}


def _close(*colls):
    for c in colls:
        c.close()


@pytest.mark.parametrize("quant", [64, 32, 8, 4])
def test_export_import_roundtrip(tmp_path, rng, quant):
    vecs = rng.uniform(-1, 1, size=(25, 6))
    metas = [json.dumps({"i": i, "tag": ["a", "b"]}).encode()
             for i in range(25)]
    src = _both(tmp_path, quant, vecs, metas)
    text = _export("torch", src["torch"])
    assert text == _export("jax", src["jax"])
    exported = json.loads(text)
    assert exported["collection"]["quantization"] == quant
    assert len(exported["records"]) == 25

    dst = {pkg: PKGS[pkg][1].import_json(
        str(tmp_path / pkg / "dst.dat"), io.StringIO(text), **PKGS[pkg][2])
        for pkg in PKGS}
    c2 = dst["torch"]
    assert c2.quantization == quant and c2.metric == "cosine"
    assert c2.get_document_count() == 25
    for i in range(25):
        d1, d2 = src["torch"].get_document(i), c2.get_document(i)
        dj = dst["jax"].get_document(i)
        # vectors pass a float-text round trip; the quantized values match
        np.testing.assert_allclose(d2.vector, d1.vector, atol=1e-12)
        np.testing.assert_array_equal(d2.vector, dj.vector)
        assert json.loads(d2.metadata) == json.loads(d1.metadata)
        assert d2.metadata == dj.metadata
    assert _stored(c2) == _stored(dst["jax"])

    c2.close()
    c3 = _open("torch", tmp_path / "torch" / "dst.dat", 6)
    assert c3.get_document_count() == 25
    _close(c3, dst["jax"], *src.values())


@pytest.mark.parametrize("quant", [64, 32, 16, 8, 4])
def test_compact_export_import_bit_identical(tmp_path, rng, quant):
    """A compact (packed+b64) export restores bit-identical storage at
    every width: the same span-log stream bytes, host codes and search
    results; the text is the JAX package's."""
    dims = 7  # odd: exercises the 4-bit pad nibble
    vecs = rng.uniform(-1, 1, size=(40, dims))
    src = _both(tmp_path, quant, vecs,
                [json.dumps({"i": i}).encode() for i in range(40)])
    c = src["torch"]
    text = _export("torch", c, compact=True)
    assert text == _export("jax", src["jax"], compact=True)
    exported = json.loads(text)
    assert exported["collection"]["vector_encoding"] == "packed+b64"
    assert all(isinstance(r["vector"], str) for r in exported["records"])

    c2 = tdump.import_json(str(tmp_path / "torch" / "dst.dat"),
                           io.StringIO(text), device="cpu")
    assert c2.get_document_count() == 40
    # the marker must not leak into the restored collection's options
    assert "vector_encoding" not in c2.options.to_json().decode()
    assert _stored(c2) == _stored(c)
    np.testing.assert_array_equal(c.columns.codes[:40], c2.columns.codes[:40])
    q = rng.uniform(-1, 1, size=dims)
    r1 = c.search(tdb.SearchArgs(vector=q, k=5, precision="exact"))
    r2 = c2.search(tdb.SearchArgs(vector=q, k=5, precision="exact"))
    rj = src["jax"].search(jdb.SearchArgs(vector=q, k=5, precision="exact"))
    assert [(x.id, x.distance) for x in r1.results] == \
        [(x.id, x.distance) for x in r2.results] == \
        [(x.id, x.distance) for x in rj.results]
    c2.close()
    c3 = _open("torch", tmp_path / "torch" / "dst.dat", dims)
    assert c3.get_document_count() == 40
    _close(c3, *src.values())


def test_compact_import_rejects_wrong_payload(tmp_path):
    c = _build("torch", tmp_path / "w.dat", 8, np.zeros((1, 4)), [b"{}"])
    text = _export("torch", c, compact=True)
    c.close()
    bad = text.replace('"vector": "', '"vector": "AAAA')
    unknown = text.replace("packed+b64", "mystery")
    for pkg in PKGS:
        _, dump, kw = PKGS[pkg]
        with pytest.raises(ValueError, match="wrong size"):
            dump.import_json(str(tmp_path / f"{pkg}2.dat"),
                             io.StringIO(bad), **kw)
        with pytest.raises(ValueError, match="vector_encoding"):
            dump.import_json(str(tmp_path / f"{pkg}3.dat"),
                             io.StringIO(unknown), **kw)


def test_export_empty_collection(tmp_path):
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        c = _open(pkg, tmp_path / pkg / "e.dat", 3,
                  create_and_overwrite=True, index_seed=1)
        out[pkg] = (_export(pkg, c), _export(pkg, c, compact=True))
        c.close()
    assert out["torch"] == out["jax"]
    assert json.loads(out["torch"][0])["records"] == []
    c2 = tdump.import_json(str(tmp_path / "e2.dat"),
                           io.StringIO(out["jax"][1]), device="cpu")
    assert c2.get_document_count() == 0 and c2.dimension_count == 3
    c2.close()


def _dump(pkg, path) -> str:
    buf = io.StringIO()
    PKGS[pkg][1].dump_index(str(path), buf)
    return buf.getvalue()


def test_dump_index_output(tmp_path):
    p = tmp_path / "d.dat"
    c = _open("torch", p, 3, create_and_overwrite=True)
    c.add_document(1, [0.1, 0.2, 0.3], b'{"x": 1}')
    c.add_document(2, [0.4, 0.5, 0.6], b'{}')
    c.remove_document(2)
    c.close()
    out = _dump("torch", p)
    assert out == _dump("jax", p)
    assert "magic=SYZL" in out
    assert "id=''" in out          # options record
    assert "id='1'" in out
    assert "TOMBSTONE" in out      # deletion marker for id 2
    assert "BAD" not in out        # all CRCs valid


def test_dump_index_corrupt_and_bad_magic(tmp_path):
    p = tmp_path / "c.dat"
    c = _build("torch", p, 8, np.eye(3, 4), [b"{}"] * 3)
    c.close()
    data = bytearray(p.read_bytes())
    data[-3] ^= 0xFF               # the last record's CRC
    at = data.find(b"RC01", 20)
    data[at:at + 4] = b"XXXX"      # a record header: resync
    p.write_bytes(bytes(data))
    out = _dump("torch", p)
    assert out == _dump("jax", p)
    assert "CORRUPT" in out and "crc=BAD" in out
    junk = tmp_path / "j.dat"
    junk.write_bytes(b"JUNKJUNK")
    assert _dump("torch", junk) == _dump("jax", junk)
    assert "bad file magic" in _dump("torch", junk)


def _slow_export(coll) -> str:
    """The per-record export loop (get_document and json.dumps per value)."""
    slow = io.StringIO()
    slow.write("{\n  \"collection\": ")
    json.dump(json.loads(coll.options.to_json()), slow, indent=2)
    slow.write(",\n  \"records\": [")
    first = True
    for doc_id in coll.get_all_ids():
        doc = coll.get_document(doc_id)
        slow.write("," if not first else "")
        first = False
        slow.write("\n    {\"id\": %d, \"vector\": %s, \"metadata\": %s}" % (
            doc.id, json.dumps([float(v) for v in doc.vector]),
            doc.metadata.decode() if doc.metadata else "null"))
    slow.write("\n  ]\n}\n")
    return slow.getvalue()


@pytest.mark.parametrize("quant", [4, 8, 16])
def test_export_code_table_text_identical(tmp_path, rng, quant):
    """The code-table serializer emits the per-value json.dumps path's text
    (same dequantized values, same list format), and the JAX package's."""
    d = 7  # odd: exercises the 4-bit pad-nibble drop
    vecs = rng.uniform(-1.2, 1.2, size=(40, d))
    src = _both(tmp_path, quant, vecs, [b'{"k": 1}'] * 39 + [b""],
                name=f"ct{quant}.dat")
    fast = _export("torch", src["torch"])
    assert fast == _slow_export(src["torch"])
    assert fast == _export("jax", src["jax"])
    np.testing.assert_array_equal(tdump._code_texts(quant),
                                  jdump._code_texts(quant))
    _close(*src.values())


def test_export_uint64_ids(tmp_path, rng):
    """Doc ids above 2**63 export (an int64 id array would overflow)."""
    big = 2**63 + 5
    src = _both(tmp_path, 8, rng.uniform(-1, 1, (3, 4)), [b"{}"] * 3,
                ids=[1, big, 2**64 - 1])
    for compact in (False, True):
        text = _export("torch", src["torch"], compact)
        assert text == _export("jax", src["jax"], compact)
        recs = json.loads(text)["records"]
        assert [r["id"] for r in recs] == [1, big, 2**64 - 1]
    c2 = tdump.import_json(str(tmp_path / "big2.dat"), io.StringIO(text),
                           device="cpu")
    assert c2.get_all_ids() == [1, big, 2**64 - 1]
    assert _stored(c2) == _stored(src["torch"])
    _close(c2, *src.values())


def test_export_during_concurrent_mutations(tmp_path, rng):
    """export_json's bulk snapshot gives a parseable, internally consistent
    export while a writer thread churns the collection (the JAX package's
    test, on the port: the interleaving is not reproducible, so the
    invariants are compared, not the text)."""
    c = _build("torch", tmp_path / "concur.dat", 8,
               rng.uniform(-1, 1, (200, 8)), [b'{"v": 0}'] * 200)
    stop = threading.Event()

    def mutator():
        i = 200
        r = np.random.default_rng(1)
        while not stop.is_set():
            c.add_documents([i], r.uniform(-1, 1, (1, 8)), [b'{"v": 1}'])
            c.remove_document(i - 200)
            i += 1

    th = threading.Thread(target=mutator)
    th.start()
    try:
        for compact in (False, True) * 3:
            data = json.loads(_export("torch", c, compact))  # parseable
            recs = data["records"]
            assert len(recs) >= 190  # ~200 live at any snapshot
            ids = [r["id"] for r in recs]
            assert ids == sorted(ids) and len(set(ids)) == len(ids)
            for r in recs[:5]:
                assert len(r["vector"]) == (8 if not compact else 12)
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive()
    c.close()


def _run_cli(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_dump_export_import(tmp_path, capsys, monkeypatch):
    from syzgydb_tpu_torch.server import config as tcfg
    monkeypatch.setattr(tcfg, "global_config", tcfg.global_config)
    src = str(tmp_path / "src.dat")
    c = _open("torch", src, 3, create_and_overwrite=True)
    c.add_document(1, [0.1, 0.2, 0.3], b'{"x": 1}')
    c.close()
    folder = ["--data-folder", str(tmp_path)]

    rc, out = _run_cli(tcli.main, ["--dump", src] + folder, capsys)
    assert rc == 0 and "RECORD" in out
    assert out == _dump("jax", src)
    cj = _open("jax", src, 3)
    for extra in ([], ["--compact"]):
        rc, exported = _run_cli(tcli.main, ["--export", src] + extra +
                                folder, capsys)
        assert rc == 0
        assert exported == _export("jax", cj, compact=bool(extra))
        assert json.loads(exported)["records"][0]["id"] == 1

        exp_file = tmp_path / "exp.json"
        exp_file.write_text(exported)
        dst = str(tmp_path / "dst.dat")
        rc, out = _run_cli(tcli.main, ["--import", str(exp_file), "--output",
                                       dst, "--platform", "cpu"] + folder,
                           capsys)
        assert rc == 0 and f"Imported into {dst}" in out
        c2 = _open("torch", dst, 3)
        assert c2.get_document_count() == 1
        assert c2.get_document(1).metadata == b'{"x": 1}'
        c2.close()
    cj.close()


@pytest.mark.parametrize("verb", ["--import", "--import-ref"])
def test_cli_import_without_a_card_raises(tmp_path, monkeypatch, verb):
    """--platform defaults to cuda: on a host without a card the import
    raises before it reads its input or writes its output."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from syzgydb_tpu_torch.server import config as tcfg
    monkeypatch.setattr(tcfg, "global_config", tcfg.global_config)
    dst = tmp_path / "out.dat"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([verb, str(tmp_path / "missing"), "--output", str(dst),
                   "--data-folder", str(tmp_path)])
    assert not dst.exists()


# ---------------------------------------------------------------------------
# across the packages: one file, and exports carried from one to the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [4, 8, 16, 64])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_of_one_file_is_identical_in_both(tmp_path, rng, writer,
                                                 quant):
    """One .dat, written by either package, exports the same text (compact
    and not) and dumps the same text in both packages."""
    path = tmp_path / "one.dat"
    vecs = rng.uniform(-1, 1, (60, 9))
    c = _build(writer, path, quant, vecs,
               [json.dumps({"i": i}).encode() for i in range(60)])
    c.remove_document(7)
    c.update_document(8, b'{"i": "eight"}')
    c.close()
    dump = _dump("torch", path)
    assert dump == _dump("jax", path)
    opened = {pkg: _open(pkg, path, 9) for pkg in PKGS}
    for compact in (False, True):
        assert _export("torch", opened["torch"], compact) == \
            _export("jax", opened["jax"], compact)
    _close(*opened.values())


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_imports_into_the_other_package(tmp_path, rng, writer,
                                               compact):
    """An export written by either package imports into the other with
    equal ids, vectors, metadata and packed storage bytes."""
    reader = "jax" if writer == "torch" else "torch"
    vecs = rng.uniform(-1, 1, (50, 12))  # 12 bytes a row at 8 bits
    src = _build(writer, tmp_path / "src.dat", 8, vecs,
                 [json.dumps({"i": i, "s": "x" * i}).encode()
                  for i in range(50)], ids=[3 * i + 1 for i in range(50)])
    text = _export(writer, src, compact)
    _, dump, kw = PKGS[reader]
    dst = dump.import_json(str(tmp_path / "dst.dat"), io.StringIO(text),
                           batch_rows=16, **kw)
    assert dst.get_all_ids() == src.get_all_ids()
    assert _stored(dst) == _stored(src)
    for i in src.get_all_ids():
        a, b = src.get_document(i), dst.get_document(i)
        np.testing.assert_array_equal(a.vector, b.vector)
        assert a.metadata == b.metadata
    assert dst.options.index_seed == src.options.index_seed
    _close(src, dst)

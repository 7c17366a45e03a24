"""The port's capacity preflight (syzgydb_tpu_torch/core/capacity.py)
against the JAX package's, on the CPU.

The 10 cases of tests/test_capacity.py on the port: an over-capacity
ingest, single add, reopen or JSON import raises CapacityError before
anything is written; updates and free-list reuse never trip it; the REST
insert maps it to 507.  The host half runs both packages with the same
patched MemAvailable and must raise (or not) at the same calls; the device
half patches the port's own device_budget (the card's total memory), as
the JAX test patches the TPU's."""

import io
import json
import threading

import numpy as np
import pytest

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.core import capacity as jcap
from syzgydb_tpu.core.columns import ColumnStore as JColumnStore
from syzgydb_tpu_torch.core import capacity as cap
from syzgydb_tpu_torch.core.columns import ColumnStore
from syzgydb_tpu_torch.ops import quantize as qz
from syzgydb_tpu_torch.tools import dump as tdump

PKGS = {"jax": (jdb, jcap, {}), "torch": (tdb, cap, {"device": "cpu"})}


def make(tmp_path, n=0, dims=8, pkg="torch", **kw):
    db, _, ckw = PKGS[pkg]
    c = db.Collection(db.CollectionOptions(
        name=str(tmp_path / f"cap_{pkg}.dat"), distance_method=db.COSINE,
        dimension_count=dims, quantization=8, create_and_overwrite=True,
        index_seed=3, **kw), **ckw)
    if n:
        vecs = np.random.default_rng(0).uniform(-1, 1, size=(n, dims))
        c.add_documents(list(range(n)), vecs,
                        [json.dumps({"i": i}).encode() for i in range(n)])
    return c


def _host(monkeypatch, nbytes):
    for _, mod, _ in PKGS.values():
        monkeypatch.setattr(mod, "host_available", lambda: nbytes)


def test_grown_capacity_mirrors_column_store():
    cs, js = ColumnStore(4, 8), JColumnStore(4, 8)
    for want in (1, 1000, 1025, 5000, 300_000):
        cs._grow(want)
        js._grow(want)
        assert cs.capacity == cap.grown_capacity(0, want) == js.capacity
    # the linear-growth regime stays 8192-aligned
    big = cap.grown_capacity(1 << 22, (1 << 22) + 1)
    assert big % 8192 == 0 and big > (1 << 22)
    assert big == jcap.grown_capacity(1 << 22, (1 << 22) + 1)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_over_capacity_ingest_raises_cleanly(tmp_path, monkeypatch, pkg):
    db = PKGS[pkg][0]
    c = make(tmp_path, n=10, pkg=pkg)
    _host(monkeypatch, 1 << 17)  # 128 KiB
    size = c.compute_stats().storage_size
    with pytest.raises(PKGS[pkg][1].CapacityError, match="host RAM"):
        c.add_documents(list(range(100, 5100)), np.zeros((5000, 8)),
                        [b"{}"] * 5000)
    # nothing was written: count and file unchanged, the collection serves
    assert c.get_document_count() == 10
    assert c.compute_stats().storage_size == size
    res = c.search(db.SearchArgs(vector=np.zeros(8), k=3))
    assert len(res.results) == 3
    c.close()


def test_within_capacity_ingest_unaffected(tmp_path, monkeypatch):
    _host(monkeypatch, 8 << 30)
    for pkg in PKGS:
        c = make(tmp_path, n=10, pkg=pkg)
        c.add_documents([100, 101], np.zeros((2, 8)), [b"{}", b"{}"])
        assert c.get_document_count() == 12
        c.close()


def test_single_add_over_capacity_raises(tmp_path, monkeypatch):
    """The add that would grow capacity raises, at the same id in both;
    a rewrite of an existing id never grows and passes."""
    failed_at = {}
    for pkg in PKGS:
        c = make(tmp_path, n=10, pkg=pkg)
        monkeypatch.setattr(PKGS[pkg][1], "host_available", lambda: 1 << 16)
        c.add_document(5, np.zeros(8), b"{}")  # rewrite: no growth check
        with pytest.raises(PKGS[pkg][1].CapacityError):
            for i in range(2000):  # crosses the 1024 initial capacity
                c.add_document(10_000 + i, np.zeros(8), b"{}")
        failed_at[pkg] = c.get_document_count()
        c.close()
    assert failed_at["torch"] == failed_at["jax"] == 1024


def test_over_capacity_reopen_raises(tmp_path, monkeypatch):
    for pkg in PKGS:
        c = make(tmp_path, n=50, pkg=pkg)
        name = c.options.name
        c.close()
    _host(monkeypatch, 1 << 12)  # 4 KiB
    for pkg in PKGS:
        db, mod, ckw = PKGS[pkg]
        with pytest.raises(mod.CapacityError):
            db.Collection(db.CollectionOptions(
                name=str(tmp_path / f"cap_{pkg}.dat"), dimension_count=8,
                quantization=8), **ckw)


def test_device_budget_check(tmp_path, monkeypatch):
    _host(monkeypatch, 64 << 30)
    colls = {pkg: make(tmp_path, n=10, pkg=pkg) for pkg in PKGS}
    # a 1 MiB card: the port's estimate holds the search transient (K4's
    # surface budget, 4 GiB at any capacity), so the budget is patched
    # after the collections are made
    monkeypatch.setattr(cap, "device_budget", lambda device: 1 << 20)
    monkeypatch.setattr(jcap, "device_budget", lambda: 1 << 20)
    for pkg, match in (("torch", "GPU"), ("jax", "HBM")):
        c = colls[pkg]
        with pytest.raises(PKGS[pkg][1].CapacityError, match=match):
            c.add_documents(list(range(100, 40_100)),
                            np.zeros((40_000, 8)), [b"{}"] * 40_000)
        assert c.get_document_count() == 10
        c.close()


def test_update_batches_never_trip_preflight(tmp_path, monkeypatch):
    """Re-ingesting existing ids (and filling free-list rows) allocates
    nothing, so it passes even when the next growth rung would not fit."""
    for pkg in PKGS:
        c = make(tmp_path, n=100, pkg=pkg)
        monkeypatch.setattr(PKGS[pkg][1], "host_available", lambda: 1)
        c.add_documents(list(range(100)), np.zeros((100, 8)),
                        [b'{"u": 1}'] * 100)
        assert c.get_document_count() == 100
        # free-list reuse: remove, then add a different id in its row
        c.remove_document(7)
        c.add_document(5007, np.zeros(8), b"{}")
        # the packed path takes the same accounting
        packed = qz.pack_vectors(np.zeros((100, 8)), 8)
        c.add_documents_packed(list(range(100)), packed, [b"{}"] * 100)
        c.close()


def test_meta_memo_reset_on_rewrite(tmp_path):
    """A row rewritten with invalid metadata after its valid bytes were
    memoized must not splice raw, in either package."""
    for pkg in PKGS:
        db = PKGS[pkg][0]
        result = db.SearchResult
        c = make(tmp_path, n=4, pkg=pkg)
        r1 = c.search(db.SearchArgs(vector=np.zeros(8), k=1)).results[0]
        assert c.metadata_json_ok(r1)  # memoizes the row
        # rewrite the same id (same row) with non-JSON metadata
        c.add_document(r1.id, np.zeros(8), b"not json")
        r2 = c.search(db.SearchArgs(vector=np.zeros(8), k=4))
        bad = [r for r in r2.results if r.id == r1.id][0]
        assert bad.metadata == b"not json"
        assert not c.metadata_json_ok(bad)
        # row reuse through remove and re-add revalidates too
        c.remove_document(r1.id)
        c.add_document(9001, np.zeros(8), b"also not json")
        res = result(9001, c.columns.metadata[c.columns._row_of[9001]], 0.0)
        assert not c.metadata_json_ok(res)
        # update_document path
        c.add_document(9002, np.zeros(8), b'{"ok": 1}')
        r = result(9002, c.columns.metadata[c.columns._row_of[9002]], 0.0)
        assert c.metadata_json_ok(r)
        c.update_document(9002, b"nope")
        r = result(9002, c.columns.metadata[c.columns._row_of[9002]], 0.0)
        assert not c.metadata_json_ok(r)
        c.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rest_insert_maps_capacity_error_to_507(tmp_path, monkeypatch, pkg):
    from tests.test_torch_rest import Pkg, make_coll, req

    p = Pkg(pkg)
    monkeypatch.setattr(PKGS[pkg][1], "host_available", lambda: 1 << 16)
    srv = p.make_server(tmp_path)
    httpd = p.rest.make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, _ = make_coll(base, dims=4)
        assert code == 201
        code, body = req(base, "POST", "/api/v1/collections/test/records",
                         [{"id": i, "vector": [0, 0, 0, 0.1]}
                          for i in range(3000)])
        assert code == 507
        assert "host RAM" in str(body)
        assert srv.collections["test"].get_document_count() == 0
    finally:
        httpd.shutdown()
        for c in srv.collections.values():
            c.close()


def test_put_many_installs_bytes_before_memo_reset(tmp_path):
    """Write order: the memo reset follows the metadata bytes install, as
    in put/set_metadata.  Reset-first reopens the stale-True race: a reader
    that validated the old bytes after the reset would memoize True, pass
    its identity re-check, and the new unvalidated bytes would then be
    spliced verbatim into REST responses."""
    c = make(tmp_path, n=8)
    cols = c.columns
    events = []

    class TraceList(list):
        def __setitem__(self, i, v):
            events.append("md")
            super().__setitem__(i, v)

    class TraceOk(np.ndarray):
        def __setitem__(self, idx, v):
            events.append("ok")
            super().__setitem__(idx, v)

    cols.metadata = TraceList(cols.metadata)
    cols.meta_ok = cols.meta_ok.view(TraceOk)
    ids = np.array([1, 2, 3], dtype=np.uint64)  # existing rows: no growth
    cols.put_many(ids, np.zeros((3, 8)), [b"{}"] * 3)
    ok_pos = [i for i, e in enumerate(events) if e == "ok"]
    md_pos = [i for i, e in enumerate(events) if e == "md"]
    assert md_pos and ok_pos, events
    assert min(ok_pos) > max(md_pos), events  # bytes first, reset last
    c.close()


@pytest.mark.parametrize("compact", [False, True])
def test_over_capacity_import_raises_before_its_first_write(
        tmp_path, monkeypatch, compact):
    """An import into a collection that cannot hold the export raises from
    the preflight of its first batch: the new file holds the options
    record alone."""
    src = make(tmp_path, n=3000, dims=8)
    buf = io.StringIO()
    tdump.export_json(src, buf, compact=compact)
    src.close()
    monkeypatch.setattr(cap, "host_available", lambda: 1 << 16)
    dst = tmp_path / "dst.dat"
    with pytest.raises(cap.CapacityError, match="host RAM"):
        tdump.import_json(str(dst), io.StringIO(buf.getvalue()),
                          batch_rows=2000, device="cpu")
    monkeypatch.undo()
    c = tdb.Collection(tdb.CollectionOptions(name=str(dst),
                                             dimension_count=8),
                       device="cpu")
    assert c.get_document_count() == 0
    assert c.spanlog.record_count() == 0 and len(c.spanlog) == 1
    c.close()
    # the device half: the port's own budget of the card's memory
    monkeypatch.setattr(cap, "device_budget", lambda device: 1 << 16)
    with pytest.raises(cap.CapacityError, match="GPU"):
        tdump.import_json(str(dst), io.StringIO(buf.getvalue()),
                          batch_rows=2000, device="cpu")

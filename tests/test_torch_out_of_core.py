"""The port's out-of-core metadata mode (CollectionOptions.metadata_on_demand:
no metadata bytes stay resident, every read fetches from the span log)
against the JAX package's, on the CPU.

The 13 cases of tests/test_out_of_core.py on the port, each run on the same
seeded data in both packages: reads, search results (ids and metadata),
reopen, the lazy column, the streamed bulk decode and the export must be
equal — exact, since both packages store one byte format and the searches
here run on the host (small collections) in f64."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu.tools import dump as jdump
from syzgydb_tpu_torch.core.columns import _LazyMetadata
from syzgydb_tpu_torch.tools import dump as tdump

PKGS = {"jax": (jdb, {}), "torch": (tdb, {"device": "cpu"})}


def make_pair(tmp_path, rng, n=300, d=16, pkg="torch"):
    """The same data in a resident and a lazy collection of `pkg`."""
    db, kw = PKGS[pkg]
    vecs = rng.uniform(-1, 1, (n, d))
    metas = [json.dumps({"i": i, "tag": "even" if i % 2 == 0 else "odd",
                         "blob": "x" * 50}).encode() for i in range(n)]
    colls = []
    for lazy in (False, True):
        c = db.Collection(db.CollectionOptions(
            name=str(tmp_path / f"{pkg}_oc_{lazy}.dat"),
            distance_method=db.COSINE, dimension_count=d, quantization=8,
            create_and_overwrite=True, index_seed=9,
            metadata_on_demand=lazy), **kw)
        c.add_documents(list(range(n)), vecs, metas)
        colls.append(c)
    return colls[0], colls[1], vecs, metas


def make_both(tmp_path, n=300, d=16):
    """make_pair in each package, from one seed."""
    return {pkg: make_pair(tmp_path, np.random.default_rng(42), n, d, pkg)
            for pkg in PKGS}


def _close(pairs):
    for res, lazy, _, _ in pairs.values():
        res.close()
        lazy.close()


def _hits(results):
    return [(r.id, r.metadata) for r in results.results]


def test_nothing_resident_and_reads_match(tmp_path):
    pairs = make_both(tmp_path)
    _, lazy, _, metas = pairs["torch"]
    jlazy = pairs["jax"][1]
    assert isinstance(lazy.columns.metadata, _LazyMetadata)
    assert not lazy.columns.metadata_resident
    for i in (0, 7, 299):
        assert lazy.get_document(i).metadata == metas[i] == \
            jlazy.get_document(i).metadata
        assert lazy.columns.get_metadata(i) == metas[i]
        np.testing.assert_array_equal(lazy.get_document(i).vector,
                                      jlazy.get_document(i).vector)
    _close(pairs)


def test_crud_and_search_parity(tmp_path):
    pairs = make_both(tmp_path)
    got = {}
    for pkg, (res, lazy, vecs, _) in pairs.items():
        db = PKGS[pkg][0]
        q = vecs[3]
        for c in (res, lazy):
            c.update_document(5, b'{"i": 5, "tag": "updated"}')
            c.remove_document(6)
        out = []
        for kw in ({}, {"precision": "exact"},
                   {"filter_query": 'tag == "even"'},
                   {"filter_query": "i >= 100 AND i < 200"}):
            a = res.search(db.SearchArgs(vector=q, k=5, **kw))
            b = lazy.search(db.SearchArgs(vector=q, k=5, **kw))
            assert _hits(a) == _hits(b)
            out.append(_hits(b))
        # list mode with a filter walks metadata through the lazy column
        largs = db.SearchArgs(vector=None, k=0,
                              filter_query='tag == "updated"', limit=10)
        ids_a = [r.id for r in res.search(largs).results]
        ids_b = [r.id for r in lazy.search(largs).results]
        assert ids_a == ids_b == [5]
        got[pkg] = out
    assert got["torch"] == got["jax"]
    _close(pairs)


def test_reopen_keeps_mode_and_bytes(tmp_path):
    pairs = make_both(tmp_path)
    _, lazy, vecs, metas = pairs["torch"]
    path = lazy.options.name
    _close(pairs)
    # reopen without asking for the mode: stored options win
    c = tdb.Collection(tdb.CollectionOptions(name=path, dimension_count=16,
                                             quantization=8), device="cpu")
    j = jdb.Collection(jdb.CollectionOptions(name=path, dimension_count=16,
                                             quantization=8))
    assert c.options.metadata_on_demand and j.options.metadata_on_demand
    assert isinstance(c.columns.metadata, _LazyMetadata)
    assert c.get_document(42).metadata == metas[42]
    got = c.search(tdb.SearchArgs(vector=vecs[42], k=1))
    assert got.results[0].id == 42
    assert got.results[0].metadata == metas[42]
    assert _hits(got) == _hits(j.search(jdb.SearchArgs(vector=vecs[42],
                                                       k=1)))
    c.close()
    j.close()


def test_remove_under_lease_returns_none(tmp_path):
    """A row quarantined by an in-flight snapshot lease has no span-log
    entry anymore: the lazy column yields None, not an error, in both."""
    pairs = make_both(tmp_path)
    for _, lazy, _, _ in pairs.values():
        row = lazy.columns._row_of[8]
        lazy.columns.begin_lease()
        try:
            lazy.remove_document(8)
            assert lazy.columns.metadata[row] is None
        finally:
            lazy.columns.end_lease()
    _close(pairs)


def test_json_ok_validates_without_memo(tmp_path):
    from syzgydb_tpu.core.collection import SearchResult as JResult
    from syzgydb_tpu_torch.core.collection import SearchResult
    pairs = make_both(tmp_path)
    for pkg, result in (("torch", SearchResult), ("jax", JResult)):
        db = PKGS[pkg][0]
        _, lazy, vecs, _ = pairs[pkg]
        r = lazy.search(db.SearchArgs(vector=vecs[0], k=1)).results[0]
        assert lazy.metadata_json_ok(r)
        assert not lazy.columns.meta_ok[lazy.columns._row_of[r.id]]  # no memo
        assert not lazy.metadata_json_ok(result(0, b"not json", 0.0))
    _close(pairs)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rest_create_accepts_flag(tmp_path, monkeypatch, pkg):
    if pkg == "jax":
        from syzgydb_tpu.server import config as cfg_mod
        from syzgydb_tpu.server import rest as rest_mod
    else:
        from syzgydb_tpu_torch.server import config as cfg_mod
        from syzgydb_tpu_torch.server import rest as rest_mod
    monkeypatch.setattr(
        cfg_mod, "global_config",
        cfg_mod.Config(data_folder=str(tmp_path), html_root=""))
    srv = rest_mod.make_server(str(tmp_path), **PKGS[pkg][1])
    httpd = rest_mod.make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1"

    def req(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(base + path, data=data, method=method,
                                   headers={"Content-Type":
                                            "application/json"})
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read() or b"{}")

    try:
        st, _ = req("POST", "/collections", {
            "name": "oc", "vector_size": 4, "quantization": 8,
            "distance_function": "cosine", "metadata_on_demand": True})
        assert st in (200, 201)
        assert srv.collections["oc"].options.metadata_on_demand
        st, _ = req("POST", "/collections/oc/records", [
            {"id": 1, "vector": [0.1, 0.2, 0.3, 0.4],
             "metadata": {"a": "1"}}])
        assert st in (200, 201)
        st, out = req("POST", "/collections/oc/search",
                      {"vector": [0.1, 0.2, 0.3, 0.4], "k": 1})
        assert st == 200
        assert out["results"][0]["metadata"] == {"a": "1"}
    finally:
        httpd.shutdown()
        for c in srv.collections.values():
            c.close()


def test_lazy_metadata_iteration_terminates(tmp_path):
    pairs = make_both(tmp_path, n=10)
    _, lazy, _, metas = pairs["torch"]
    got = list(lazy.columns.metadata)
    assert len(got) == lazy.columns.capacity
    assert got == list(pairs["jax"][1].columns.metadata)
    live = [m for m in got if m is not None]
    assert sorted(live) == sorted(metas)
    _close(pairs)


def _logs(tmp_path):
    from syzgydb_tpu.core.storage import SpanLog as JLog
    from syzgydb_tpu_torch.core.storage import SpanLog
    return SpanLog(str(tmp_path / "p.dat")), JLog(str(tmp_path / "j.dat"))


def test_read_stream0_matches_full_read(tmp_path):
    small = b'{"k": 1}'
    big = b'{"blob": "' + b"y" * 10_000 + b'"}'  # spills past the 4KB pread
    for log in _logs(tmp_path):
        log.write("1", [small, b"\x01\x02\x03"])
        log.write("2", [big, b"\x04" * 400])
        assert log.read_stream0("1") == small == log.read("1")[0]
        assert log.read_stream0("2") == big == log.read("2")[0]
        log.write("1", [b'{"k": 2}', b"\x05"])  # superseding write
        assert log.read_stream0("1") == b'{"k": 2}'
        with pytest.raises(KeyError):
            log.read_stream0("missing")
        log.close()
    assert (tmp_path / "p.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()


def test_bulk_rows_streamed_parity(tmp_path):
    """want_metas=False (bounded chunks, pread) gives the whole-image
    path's ids and vectors, across many chunks, in both packages."""
    n = 64
    vals = [bytes([i] * 24) for i in range(n)]
    got = []
    for log in _logs(tmp_path):
        for i in range(n):
            log.write(str(i), [b'{"i": %d}' % i, vals[i]])
        ids_a, metas_a, vec_a = log.bulk_rows()
        ids_b, metas_b, vec_b = log.bulk_rows(want_metas=False,
                                              chunk_bytes=256)  # many chunks
        assert metas_b is None
        a = dict(zip(ids_a, map(bytes, vec_a)))
        assert a == dict(zip(ids_b, map(bytes, vec_b)))
        got.append((a, [bytes(m) for m in metas_a]))
        log.close()
    assert got[0] == got[1]


def test_out_of_core_reopen_uses_streamed_replay(tmp_path, monkeypatch):
    """Reopen of a lazy collection does not read the whole file image."""
    from syzgydb_tpu_torch.core import storage as st_mod
    pairs = make_both(tmp_path, n=120)
    _, lazy, vecs, _ = pairs["torch"]
    path = lazy.options.name
    _close(pairs)
    seen = {}
    orig = st_mod.SpanLog.bulk_rows

    def spy(self, want_metas=True, chunk_bytes=64 << 20):
        seen["want_metas"] = want_metas
        return orig(self, want_metas, chunk_bytes)

    monkeypatch.setattr(st_mod.SpanLog, "bulk_rows", spy)
    c = tdb.Collection(tdb.CollectionOptions(name=path, dimension_count=16,
                                             quantization=8), device="cpu")
    assert seen["want_metas"] is False
    assert c.search(tdb.SearchArgs(vector=vecs[7], k=1)).results[0].id == 7
    c.close()


def test_native_projection_chunked_when_lazy(tmp_path, monkeypatch):
    """Filters on out-of-core collections fetch metadata in bounded chunks;
    results match the resident engine's and the JAX package's."""
    from syzgydb_tpu.query import columnar as jcolumnar
    from syzgydb_tpu_torch.query import columnar
    monkeypatch.setattr(columnar, "_OOC_PROJECT_CHUNK", 16)
    monkeypatch.setattr(jcolumnar, "_OOC_PROJECT_CHUNK", 16)
    pairs = make_both(tmp_path)
    for fq in ('tag == "even"', "i >= 42 AND i < 77"):
        got = {}
        for pkg, (res, lazy, vecs, _) in pairs.items():
            args = PKGS[pkg][0].SearchArgs(vector=vecs[0], k=8,
                                           filter_query=fq)
            a = [r.id for r in res.search(args).results]
            b = [r.id for r in lazy.search(args).results]
            assert a == b
            got[pkg] = b
        assert got["torch"] == got["jax"]
    _close(pairs)


def test_fair_lock_acquire_exception_cleans_ticket():
    """An exception inside the blocked wait leaves no orphaned ticket to
    deadlock later acquirers."""
    from syzgydb_tpu_torch.utils.locks import FairRLock
    lk = FairRLock()
    lk.acquire()  # main holds

    boom = {"n": 0}
    orig_wait = lk._cv.wait

    def exploding_wait(timeout=None):
        boom["n"] += 1
        raise RuntimeError("interrupted")

    lk._cv.wait = exploding_wait
    err = []

    def b():
        try:
            lk.acquire()
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=b)
    t.start()
    t.join(5)
    assert not t.is_alive()
    assert err and boom["n"] == 1
    lk._cv.wait = orig_wait
    assert not lk._queue  # ticket cleaned up
    lk.release()
    got = []

    def c():
        with lk:
            got.append(True)

    t2 = threading.Thread(target=c)
    t2.start()
    t2.join(5)
    assert not t2.is_alive()
    assert got == [True]  # no deadlock


def test_export_streams_metadata_not_resident(tmp_path):
    """Export of a metadata_on_demand collection runs at bounded memory:
    the codes ride the streamed want_metas=False bulk_rows path and the
    metadata is read per chunk.  The records are the resident collection's
    and, with the header, the JAX package's lazy collection's."""
    pairs = make_both(tmp_path, n=120)
    res, lazy, _, _ = pairs["torch"]
    jlazy = pairs["jax"][1]
    calls = []
    orig = lazy.spanlog.bulk_rows
    lazy.spanlog.bulk_rows = lambda want_metas=True, **kw: (
        calls.append(want_metas) or orig(want_metas=want_metas, **kw))
    for compact in (False, True):
        a, b, j = io.StringIO(), io.StringIO(), io.StringIO()
        tdump.export_json(res, a, compact=compact)
        tdump.export_json(lazy, b, compact=compact)
        jdump.export_json(jlazy, j, compact=compact)
        # identical except the collection header (name/metadata_on_demand)
        a_recs = a.getvalue().split('"records"')[1]
        b_recs = b.getvalue().split('"records"')[1]
        assert a_recs == b_recs
        assert b.getvalue().replace("torch_", "jax_") == j.getvalue()
    assert calls and all(c is False for c in calls)
    _close(pairs)

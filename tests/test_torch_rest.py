"""The port's REST server (syzgydb_tpu_torch.server, device="cpu") against
the JAX package's, on the CPU.

The flows of tests/test_rest.py run against either package's server (the
`pkg` fixture is parametrized over "jax" and "torch"); the port's
use_mesh="auto" runs with parallel.mesh.visible_devices patched to eight
CPU devices.  The REST text-search flows of tests/test_embedder.py
(embedder="device" with the shipped checkpoint and with an HF checkpoint
directory) run on both servers too.  A scripted differential
sequence then drives both servers on the same seeded documents, at
quantization 8 and 64, cosine and euclidean, with HOST_SCAN_MAX_ELEMS as it
stands and patched to 0 in both packages (the device branches: XLA on the
JAX side, the kernels' plain versions on the port's): statuses, JSON key
order and ids must be equal, and distances within twice the rerank's f32
accumulation cushion (scan.surface_accum_eps) in surrogate units; the
timing fields (search_time, queue_wait_time, embedding_time) are not
compared.  A data folder the JAX server
wrote opens in the port's server and answers the same searches.  The CLI's
--serve --platform cpu is driven with scripts/testserver.sh."""

import hashlib
import http.client
import io
import json
import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """One package's server modules, and its constructors with the port's
    device argument ("cpu") where the package takes one."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import syzgydb_tpu as db
            from syzgydb_tpu.core import collection
            from syzgydb_tpu.server import batcher, config, embedding, rest
            self.kw = {}
        else:
            import syzgydb_tpu_torch as db
            from syzgydb_tpu_torch.core import collection
            from syzgydb_tpu_torch.server import (batcher, config, embedding,
                                                  rest)
            self.kw = {"device": "cpu"}
        self.db, self.coll_mod, self.batcher = db, collection, batcher
        self.config, self.embedding, self.rest = config, embedding, rest

    def make_server(self, folder, **kw):
        return self.rest.make_server(str(folder), **kw, **self.kw)

    def Server(self, folder):
        return self.rest.Server(data_folder=str(folder), **self.kw)

    def Collection(self, opts):
        return self.db.Collection(opts, **self.kw)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return Pkg(request.param)


def mock_embed(texts, use_cache):
    """Deterministic fake embedding: stable hash of text -> 4-d vector."""
    out = []
    for t in texts:
        h = hashlib.blake2s(t.encode(), digest_size=4).digest()
        out.append([b / 256.0 for b in h])
    return out


def start(srv, rest):
    httpd = rest.make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def close_all(srv):
    for c in srv.collections.values():
        if c is not None:
            c.close()


@pytest.fixture
def server(pkg, tmp_path, monkeypatch):
    monkeypatch.setattr(
        pkg.config, "global_config",
        pkg.config.Config(data_folder=str(tmp_path), html_root=""))
    monkeypatch.setattr(pkg.embedding, "embed_text", mock_embed)
    srv = pkg.make_server(tmp_path)
    httpd, base = start(srv, pkg.rest)
    yield base
    httpd.shutdown()
    close_all(srv)


def req(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def make_coll(base, name="test", dims=4, quant=8, dist="cosine"):
    return req(base, "POST", "/api/v1/collections", {
        "name": name, "vector_size": dims, "quantization": quant,
        "distance_function": dist})


# ---------------------------------------------------------------------------
# the flows of tests/test_rest.py, on both servers
# ---------------------------------------------------------------------------

def test_create_list_info_delete_collection(server):
    code, body = make_coll(server)
    assert code == 201
    assert body["collection_name"] == "test"
    code, _ = make_coll(server)
    assert code == 400
    code, _ = req(server, "POST", "/api/v1/collections",
                  {"name": "x", "vector_size": 4, "quantization": 8,
                   "distance_function": "manhattan"})
    assert code == 400
    code, listing = req(server, "GET", "/api/v1/collections")
    assert code == 200
    assert [c["name"] for c in listing] == ["test"]
    assert listing[0]["quantization"] == 8
    code, info = req(server, "GET", "/api/v1/collections/test")
    assert code == 200
    assert info["dimension_count"] == 4
    assert info["distance_method"] == "cosine"
    assert list(info) == ["document_count", "dimension_count", "quantization",
                          "distance_method", "storage_size",
                          "average_distance", "name"]
    code, body = req(server, "DELETE", "/api/v1/collections/test")
    assert code == 200
    code, body = req(server, "DELETE", "/api/v1/collections/test")
    assert code == 200
    assert body["message"] == "Collection did not exist."
    code, _ = req(server, "GET", "/api/v1/collections/test")
    assert code == 404


def test_insert_search_roundtrip(server):
    make_coll(server, dims=4)
    records = [{"id": i, "vector": [i / 10, 0.5, -0.5, 0.1],
                "metadata": {"tag": f"t{i}"}} for i in range(20)]
    code, _ = req(server, "POST", "/api/v1/collections/test/records", records)
    assert code == 201
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"vector": [0.05, 0.5, -0.5, 0.1], "k": 3})
    assert code == 200
    assert list(res) == ["results", "percent_searched", "search_time",
                         "queue_wait_time", "embedding_time"]
    assert len(res["results"]) == 3
    assert list(res["results"][0]) == ["id", "metadata", "distance"]
    assert res["results"][0]["metadata"]["tag"].startswith("t")
    d = [r["distance"] for r in res["results"]]
    assert d == sorted(d)


def test_insert_with_text_embedding(server):
    make_coll(server, dims=4)
    code, _ = req(server, "POST", "/api/v1/collections/test/records",
                  [{"id": 1, "text": "hello world", "metadata": {}}])
    assert code == 201
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"text": "hello world", "k": 1})
    assert code == 200
    assert res["results"][0]["id"] == 1
    assert res["results"][0]["distance"] < 0.01


def test_insert_requires_vector_or_text(server):
    make_coll(server, dims=4)
    code, _ = req(server, "POST", "/api/v1/collections/test/records",
                  [{"id": 1, "metadata": {}}])
    assert code == 400
    code, _ = req(server, "POST", "/api/v1/collections/test/records",
                  {"id": 1, "vector": [0, 0, 0, 0]})
    assert code == 400


def test_update_and_delete_record(server):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": 5, "vector": [0.1, 0.2, 0.3, 0.4], "metadata": {"a": "1"}}])
    code, body = req(server, "PUT",
                     "/api/v1/collections/test/records/5/metadata",
                     {"metadata": {"a": "2"}})
    assert code == 200 and body["id"] == 5
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"k": 1, "vector": [0.1, 0.2, 0.3, 0.4]})
    assert res["results"][0]["metadata"] == {"a": "2"}
    code, _ = req(server, "PUT",
                  "/api/v1/collections/test/records/99/metadata",
                  {"metadata": {}})
    assert code == 404
    code, body = req(server, "DELETE", "/api/v1/collections/test/records/5")
    assert code == 200
    code, _ = req(server, "DELETE", "/api/v1/collections/test/records/5")
    assert code == 404


def test_ids_endpoint(server):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": i, "vector": [0, 0, 0, 0.1]} for i in (3, 1, 2)])
    code, ids = req(server, "GET", "/api/v1/collections/test/ids")
    assert code == 200
    assert ids == [1, 2, 3]


def test_filtered_search(server):
    make_coll(server, dims=4)
    recs = [{"id": i, "vector": [i / 20, 0.1, 0.1, 0.1],
             "metadata": {"kind": "even" if i % 2 == 0 else "odd"}}
            for i in range(10)]
    req(server, "POST", "/api/v1/collections/test/records", recs)
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"vector": [0.0, 0.1, 0.1, 0.1], "k": 20,
                     "filter": "kind == 'odd'"})
    assert code == 200
    assert len(res["results"]) == 5
    assert all(r["id"] % 2 == 1 for r in res["results"])
    code, _ = req(server, "POST", "/api/v1/collections/test/search",
                  {"vector": [0, 0, 0, 0], "k": 1, "filter": "=="})
    assert code == 400


@pytest.mark.parametrize("flt,want", [
    ("user.age > 50", {6, 7, 8, 9}),
    ("user.age > :minage", {3, 4, 5, 6, 7, 8, 9}),
    ("tags.length == 2", {2, 5, 8}),
    ("tags[0] == 't'", {1, 2, 4, 5, 7, 8}),
    ("LENGTH(tags) == 0", {0, 3, 6, 9}),
    ("price > cost", {6, 7, 8, 9}),
])
def test_filtered_search_path_expressions(server, flt, want):
    make_coll(server, dims=4)
    recs = [{"id": i, "vector": [i / 20, 0.1, 0.1, 0.1],
             "metadata": {"user": {"age": i * 10}, "tags": ["t"] * (i % 3),
                          "minage": 25, "price": i, "cost": 5}}
            for i in range(10)]
    req(server, "POST", "/api/v1/collections/test/records", recs)
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"vector": [0.0, 0.1, 0.1, 0.1], "k": 20,
                     "filter": flt, "precision": "exact"})
    assert code == 200, flt
    assert {r["id"] for r in res["results"]} == want, flt


@pytest.mark.parametrize("flt,want", [
    ("ANY(items, price > 7)", {8}),
    ("ALL(items, price >= 4)", {0, 3, 4, 5, 6, 7, 8, 9}),
    ("ANY(items[*], price == 5)", {5}),
    ("tags == ['red', 'blue']", {1, 3, 5, 7, 9}),
    ("tags != ['red', 'blue']", {0, 2, 4, 6, 8}),
    ("NOT ANY(items, price > 0) AND tags == ['green']", {0, 6}),
])
def test_filtered_search_quantifiers(server, flt, want):
    make_coll(server, dims=4)
    recs = [{"id": i, "vector": [i / 20, 0.1, 0.1, 0.1],
             "metadata": {"items": [{"price": j + i} for j in range(i % 3)],
                          "tags": ["red", "blue"] if i % 2 else ["green"]}}
            for i in range(10)]
    req(server, "POST", "/api/v1/collections/test/records", recs)
    code, res = req(server, "POST", "/api/v1/collections/test/search",
                    {"vector": [0.0, 0.1, 0.1, 0.1], "k": 20,
                     "filter": flt, "precision": "exact"})
    assert code == 200, flt
    assert {r["id"] for r in res["results"]} == want, flt


def test_pagination_list_mode(server):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": i, "vector": [0, 0, 0, 0.1]} for i in range(1, 6)])
    for offset, limit, want in [(0, 2, [1, 2]), (2, 2, [3, 4]), (4, 2, [5]),
                                (0, 0, [1, 2, 3, 4, 5])]:
        code, res = req(server, "POST", "/api/v1/collections/test/search",
                        {"offset": offset, "limit": limit})
        assert code == 200
        assert [r["id"] for r in res["results"]] == want


def test_ui_page_walk(server):
    page = 50  # PAGE_SIZE in html/app.js
    make_coll(server, dims=4)
    n = 123
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": i, "vector": [0, 0, 0, 0.1]} for i in range(n)])
    seen, off = [], 0
    while True:
        code, res = req(server, "POST", "/api/v1/collections/test/search",
                        {"offset": off, "limit": page})
        assert code == 200
        ids = [r["id"] for r in res["results"]]
        assert len(ids) <= page
        seen.extend(ids)
        off += page
        if len(ids) < page:
            break
    assert sorted(seen) == list(range(n))
    assert seen == sorted(seen, key=str)


def test_search_get_method(server):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": 1, "text": "alpha"}])
    code, res = req(server, "GET",
                    "/api/v1/collections/test/search?text=alpha&k=1")
    assert code == 200
    assert res["results"][0]["id"] == 1


def test_search_on_missing_collection(server):
    code, _ = req(server, "POST", "/api/v1/collections/none/search",
                  {"k": 1, "vector": [0, 0, 0, 0]})
    assert code == 404


def test_persistence_across_server_restart(pkg, server, tmp_path):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": 7, "vector": [0.1, 0.2, 0.3, 0.4], "metadata": {"x": "y"}}])
    srv2 = pkg.make_server(tmp_path)
    assert "test" in srv2.collections
    assert srv2.collections["test"].get_document(7).metadata == b'{"x": "y"}'
    close_all(srv2)


def test_embedding_cache_lru(pkg):
    cache = pkg.embedding.LRUCache(capacity=2)
    cache.put("a", [1.0])
    cache.put("b", [2.0])
    assert cache.get("a") == [1.0]
    cache.put("c", [3.0])  # evicts LRU ("b")
    assert cache.get("b") is None
    assert cache.get("a") == [1.0]
    assert cache.get("c") == [3.0]
    assert len(cache) == 2


def test_search_uses_cache_inserts_dont(pkg, server, monkeypatch):
    calls = []
    emb = pkg.embedding

    def counting_embed(texts, use_cache):
        calls.append((tuple(texts), use_cache))
        if use_cache:
            cached = [emb.embedding_cache.get(t) for t in texts]
            if all(c is not None for c in cached):
                return cached
        out = mock_embed(texts, use_cache)
        if use_cache:
            for t, e in zip(texts, out):
                emb.embedding_cache.put(t, e)
        return out

    monkeypatch.setattr(emb, "embed_text", counting_embed)
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": 1, "text": "q"}])
    assert calls[-1][1] is False  # inserts bypass the cache
    req(server, "POST", "/api/v1/collections/test/search",
        {"text": "q", "k": 1})
    assert calls[-1][1] is True  # searches use it


def test_ollama_client_posts_batches_and_caches(pkg, monkeypatch):
    """embed_text_ollama against a local stand-in of the Ollama API: one
    batched POST of {"model", "input"}; a cached search text posts
    nothing."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    seen = []

    class Ollama(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            seen.append((self.path, body))
            out = json.dumps({"embeddings": [[float(len(t))] * 2
                                             for t in body["input"]]})
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out.encode())

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Ollama)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        monkeypatch.setattr(pkg.config, "global_config", pkg.config.Config(
            ollama_server=f"127.0.0.1:{httpd.server_address[1]}"))
        monkeypatch.setattr(pkg.embedding, "embedding_cache",
                            pkg.embedding.LRUCache())
        fn = pkg.embedding.embed_text_ollama
        assert fn(["ab", "c"], False) == [[2.0, 2.0], [1.0, 1.0]]
        assert seen == [("/api/embed", {"model": "all-minilm",
                                        "input": ["ab", "c"]})]
        assert len(pkg.embedding.embedding_cache) == 0
        assert fn(["xyz"], True) == [[3.0, 3.0]]
        assert fn(["xyz"], True) == [[3.0, 3.0]]
        assert len(seen) == 2
    finally:
        httpd.shutdown()


def test_get_search_ignores_vector_param(server):
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": 1, "vector": [0.1, 0.1, 0.1, 0.1]}])
    code, res = req(server, "GET",
                    "/api/v1/collections/test/search"
                    "?vector=[0.1,0.1,0.1,0.1]&limit=5")
    assert code == 200
    assert res["results"][0]["distance"] == 0.0


def test_create_with_tuning_knobs(server):
    code, _ = req(server, "POST", "/api/v1/collections", {
        "name": "tuned", "vector_size": 4, "quantization": 8,
        "distance_function": "cosine", "search_budget": 512,
        "index_tables": 6, "index_bits_per_table": 32})
    assert code == 201
    code, info = req(server, "GET", "/api/v1/collections/tuned")
    assert code == 200


def test_create_rejects_overflowing_sketch_bits(server):
    code, _ = req(server, "POST", "/api/v1/collections", {
        "name": "overflow", "vector_size": 4, "quantization": 8,
        "distance_function": "cosine",
        "index_tables": 8, "index_bits_per_table": 32})
    assert code == 400
    code, _ = req(server, "POST", "/api/v1/collections", {
        "name": "overflow", "vector_size": 4, "quantization": 8,
        "distance_function": "cosine"})
    assert code == 201
    code, _ = req(server, "POST", "/api/v1/collections", {
        "name": "noveclen", "distance_function": "cosine"})
    assert code == 400
    code, _ = req(server, "POST", "/api/v1/collections", {
        "name": "noveclen", "vector_size": 3,
        "distance_function": "cosine"})
    assert code == 201


def test_static_traversal_blocked(pkg, tmp_path, monkeypatch):
    root = tmp_path / "html"
    root.mkdir()
    (root / "index.html").write_text("ok")
    evil = tmp_path / "html_private"
    evil.mkdir()
    (evil / "secrets.txt").write_text("SECRET")
    monkeypatch.setattr(pkg.config.global_config, "html_root", str(root))
    httpd, _ = start(pkg.Server(tmp_path), pkg.rest)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1])
        conn.request("GET", "/")
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"ok")
        conn.putrequest("GET", "/../html_private/secrets.txt",
                        skip_host=False)
        conn.endheaders()
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status in (403, 404), resp.status
        assert b"SECRET" not in body
        conn.close()
    finally:
        httpd.shutdown()


def test_collection_name_path_escape_rejected(pkg, tmp_path):
    httpd, base = start(pkg.Server(tmp_path), pkg.rest)
    try:
        for bad in ("/tmp/evil", "../evil", "a/b", ".hidden", ""):
            code, _ = req(base, "POST", "/api/v1/collections",
                          {"name": bad, "vector_size": 4,
                           "distance_function": "cosine"})
            assert code == 400, bad
        assert os.listdir(tmp_path) == []
    finally:
        httpd.shutdown()


def test_get_search_bad_numeric_params_parity(pkg, tmp_path, rng):
    srv = pkg.Server(tmp_path)
    c = pkg.Collection(pkg.db.CollectionOptions(
        name=str(tmp_path / "p.dat"), distance_method=pkg.db.COSINE,
        dimension_count=4, quantization=8, create_and_overwrite=True,
        index_seed=2))
    c.add_documents([1, 2], rng.uniform(-1, 1, (2, 4)), [b"{}", b"{}"])
    srv.collections["p"] = c
    httpd, base = start(srv, pkg.rest)
    try:
        code, out = req(base, "GET", "/api/v1/collections/p/search"
                        "?k=abc&offset=x&limit=&radius=nope")
        assert code == 200
        assert len(out["results"]) == 2  # k=0 -> list mode
    finally:
        httpd.shutdown()
        c.close()


def test_gzip_above_200_bytes(server):
    """Responses gzip when the client accepts it and the body passes 200
    bytes; short bodies go out plain."""
    make_coll(server, dims=4)
    req(server, "POST", "/api/v1/collections/test/records",
        [{"id": i, "vector": [i / 10, 0.5, -0.5, 0.1],
          "metadata": {"pad": "x" * 40}} for i in range(10)])
    host = server.split("//")[1]
    conn = http.client.HTTPConnection(host)
    for k, gz in ((10, True), (0, False)):
        body = {"vector": [0.1, 0.5, -0.5, 0.1], "k": k} if k else None
        conn.request("POST" if k else "GET",
                     "/api/v1/collections/test/search" if k else
                     "/api/v1/collections/nope",
                     body=json.dumps(body) if body else None,
                     headers={"Accept-Encoding": "gzip",
                              "Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        assert (resp.getheader("Content-Encoding") == "gzip") == gz
        if gz:
            import gzip
            assert len(json.loads(gzip.decompress(raw))["results"]) == 10
    conn.close()


def test_keepalive_drains_unread_body_of_an_early_error(server):
    """An early error that never read its request body (a search on a
    missing collection) drains it, so the next request on the same
    keep-alive connection parses cleanly."""
    make_coll(server, dims=4)
    conn = http.client.HTTPConnection(server.split("//")[1])
    for path, want in (("/api/v1/collections/none/search", 404),
                       ("/api/v1/collections/test/search", 200)):
        conn.request("POST", path,
                     body=json.dumps({"vector": [0, 0, 0, 1], "k": 1}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == want
    conn.close()


def test_fast_parser_discards_fold_after_duplicate_header(pkg):
    def parse(header_blob: bytes):
        h = object.__new__(pkg.rest._Handler)
        h.raw_requestline = b"GET /x HTTP/1.1\r\n"
        h.rfile = io.BytesIO(header_blob)
        assert h.parse_request()
        return h.headers

    hd = parse(b"X-A: 1\r\nX-A: 2\r\n\tcont\r\n\r\n")
    assert hd.get("X-A") == "1"
    hd = parse(b"X-B: a\r\n  b\r\nX-C: z\r\n\r\n")
    assert hd.get("X-B") == "a b"
    assert hd.get("x-c") == "z"


def test_fast_parser_differential_vs_stdlib(pkg):
    """The fast header parser's .get() view matches
    http.client.parse_headers' on 2,000 random header blocks."""
    def fast(blob: bytes):
        h = object.__new__(pkg.rest._Handler)
        h.raw_requestline = b"GET /x HTTP/1.1\r\n"
        h.rfile = io.BytesIO(blob)
        h.send_error = lambda *a, **k: None
        return h.headers._d if h.parse_request() else None

    def std(blob: bytes):
        try:
            msg = http.client.parse_headers(io.BytesIO(blob))
        except Exception:
            return None
        return {k.lower(): msg.get(k) for k in set(msg.keys())}

    rnd = random.Random(42)
    names = ["X-A", "x-a", "Content-Length", "X-Long-Name", "A"]
    vals = ["1", "2", " spaced ", "", "a,b", "\xe9", "v\tv"]
    norm = (lambda v: " ".join(v.split()) if v is not None else None)
    for _ in range(2000):
        lines = []
        for _ in range(rnd.randint(0, 6)):
            if rnd.random() < 0.15 and lines:
                lines.append(rnd.choice([" ", "\t"]) + rnd.choice(vals))
            else:
                lines.append(rnd.choice(names) + ":" + rnd.choice(vals))
        blob = ("\r\n".join(lines) + ("\r\n" if lines else "")
                + "\r\n").encode("iso-8859-1")
        f, s = fast(blob), std(blob)
        if f is None or s is None:
            continue
        for name in set(f) | set(s):
            assert norm(f.get(name)) == norm(s.get(name)), (blob, name)


# ---------------------------------------------------------------------------
# the port's refusals and its device argument
# ---------------------------------------------------------------------------

def test_use_mesh_auto_is_a_noop_on_one_device(tmp_path, monkeypatch):
    """use_mesh=auto on fewer than two CUDA devices serves as "off" (the
    port's counterpart of test_use_mesh_auto_shards_collections)."""
    import torch

    t = Pkg("torch")
    monkeypatch.setattr(t.config.global_config, "use_mesh", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    srv = t.make_server(tmp_path)
    assert srv.collections == {} and srv.mesh is None


def test_use_mesh_auto_shards_collections(tmp_path, monkeypatch):
    """tests/test_rest.py's use_mesh=auto case on the port, with
    mesh.visible_devices patched to eight CPU devices: loaded and newly
    created collections shard over the mesh, and a sharded search through
    REST finds the query's own row."""
    import torch

    from syzgydb_tpu_torch.parallel import mesh as mesh_mod

    t = Pkg("torch")
    rng = np.random.default_rng(42)
    c0 = t.Collection(t.db.CollectionOptions(
        name=str(tmp_path / "pre.dat"), distance_method=t.db.COSINE,
        dimension_count=8, quantization=8, create_and_overwrite=True,
        index_seed=4))
    vecs = rng.uniform(-1, 1, size=(300, 8))
    c0.add_documents(list(range(300)), vecs, [b"{}"] * 300)
    c0.close()

    monkeypatch.setattr(t.config.global_config, "use_mesh", "auto")
    monkeypatch.setattr(mesh_mod, "visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    srv = t.make_server(tmp_path)
    assert srv.mesh is not None and srv.mesh.shape["data"] == 8
    assert srv.collections["pre"]._mesh is srv.mesh
    httpd, base = start(srv, t.rest)
    try:
        status, _ = req(base, "POST", "/api/v1/collections", {
            "name": "fresh", "vector_size": 8, "quantization": 8,
            "distance_function": "cosine"})
        assert status == 201
        assert srv.collections["fresh"]._mesh is srv.mesh
        status, out = req(base, "POST", "/api/v1/collections/pre/search", {
            "vector": vecs[17].tolist(), "k": 3, "precision": "exact"})
        assert status == 200 and out["results"][0]["id"] == 17
        assert len(srv.collections["pre"]._dev["codes"]) == 8
    finally:
        httpd.shutdown()
        close_all(srv)


def _device_embedder_server(pkg, tmp_path, monkeypatch, ckpt):
    """pkg's server with embedder=device and `ckpt`; the embed_text seam
    comes back at teardown."""
    monkeypatch.setattr(pkg.config, "global_config", pkg.config.Config(
        data_folder=str(tmp_path), html_root="", embedder="device",
        embedder_checkpoint=ckpt))
    monkeypatch.setattr(pkg.embedding, "embed_text",
                        pkg.embedding.embed_text)
    srv = pkg.make_server(tmp_path)
    httpd, base = start(srv, pkg.rest)
    return srv, httpd, base


def test_rest_text_search_with_trained_device_embedder(pkg, tmp_path,
                                                        monkeypatch):
    """tests/test_embedder.py's REST flow: embedder=device with the shipped
    checkpoint; text inserts embed on the server's device, and a held-out
    text query retrieves its same-topic document top-1."""
    if pkg.name == "jax":
        from syzgydb_tpu.models import train_synthetic as ts
    else:
        from syzgydb_tpu_torch.models import train_synthetic as ts
    srv, httpd, base = _device_embedder_server(pkg, tmp_path, monkeypatch,
                                               ts.DEFAULT_CHECKPOINT)
    try:
        assert make_coll(base, "txt", ts.training_config().hidden,
                         16)[0] == 201
        topics, filler = ts.make_vocab()
        rng = np.random.default_rng(31)
        doc_topics = list(range(0, 36, 3))  # 12 docs, distinct topics
        recs = [{"id": i, "text": ts.sample_doc(rng, topics[t], filler),
                 "metadata": {"topic": t}}
                for i, t in enumerate(doc_topics)]
        assert req(base, "POST", "/api/v1/collections/txt/records",
                   recs)[0] == 201
        hits = 0
        for t in doc_topics:
            q = ts.sample_doc(rng, topics[t], filler)
            code, out = req(base, "POST", "/api/v1/collections/txt/search",
                            {"text": q, "k": 1})
            assert code == 200
            hits += int(out["results"][0]["metadata"]["topic"] == t)
        assert hits >= 11, hits
    finally:
        httpd.shutdown()
        close_all(srv)


def test_rest_text_search_with_hf_checkpoint(pkg, tmp_path, monkeypatch):
    """tests/test_embedder.py's REST flow through an HF-format checkpoint
    directory: an indexed text searched by text comes back top-1."""
    transformers = pytest.importorskip("transformers")
    import torch

    cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)
    torch.manual_seed(0)
    d = tmp_path / "minilm"
    transformers.BertModel(cfg).eval().save_pretrained(str(d))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat", "sat", "on",
             "a", "mat", "hello", "world", "quick", "brown", "fox"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    srv, httpd, base = _device_embedder_server(pkg, tmp_path, monkeypatch,
                                               str(d))
    try:
        assert make_coll(base, "hf", 32, 16)[0] == 201
        texts = ["the cat sat on a mat", "hello world", "a quick brown fox"]
        assert req(base, "POST", "/api/v1/collections/hf/records",
                   [{"id": i, "text": t, "metadata": {"i": str(i)}}
                    for i, t in enumerate(texts)])[0] == 201
        for i, t in enumerate(texts):
            code, out = req(base, "POST", "/api/v1/collections/hf/search",
                            {"text": t, "k": 1})
            assert code == 200 and out["results"][0]["id"] == i, out
            assert out["results"][0]["distance"] < 1e-3
    finally:
        httpd.shutdown()
        close_all(srv)


@pytest.mark.parametrize("ckpt", ["missing", "wrong_tree"])
def test_embedder_that_fails_to_build_raises(tmp_path, monkeypatch, ckpt):
    """embedder=device with a checkpoint that does not load: make_server
    raises and the embed_text seam stays the Ollama client's."""
    from syzgydb_tpu_torch.models import ckpt_msgpack

    t = Pkg("torch")
    path = tmp_path / "emb.ckpt"
    if ckpt == "wrong_tree":
        hdr = json.dumps({"hidden": 64, "heads": 4, "layers": 1,
                          "dtype": "float32"}).encode()
        path.write_bytes(b"SYZE" + len(hdr).to_bytes(4, "little") + hdr +
                         ckpt_msgpack.dumps({"params": {}}))
    monkeypatch.setattr(t.config.global_config, "embedder", "device")
    monkeypatch.setattr(t.config.global_config, "embedder_checkpoint",
                        str(path))
    before = t.embedding.embed_text
    err = FileNotFoundError if ckpt == "missing" else ValueError
    with pytest.raises(err):
        t.make_server(tmp_path)
    assert t.embedding.embed_text is before
    assert before is t.embedding.embed_text_ollama


def test_make_server_without_device_raises_before_loading(tmp_path,
                                                          monkeypatch):
    """On this CPU-only host make_server() asks for CUDA and raises before
    its load loop, whose per-file except would otherwise swallow the
    device error file by file."""
    t = Pkg("torch")
    c = t.Collection(t.db.CollectionOptions(
        name=str(tmp_path / "a.dat"), dimension_count=4))
    c.add_document(1, [0.1, 0.2, 0.3, 0.4], b"{}")
    c.close()
    opened = []
    real = t.rest.Collection

    def spy(*a, **kw):
        opened.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(t.rest, "Collection", spy)
    with pytest.raises(RuntimeError, match="CUDA"):
        t.rest.make_server(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        t.rest.Server(str(tmp_path))
    assert opened == []
    srv = t.rest.make_server(str(tmp_path), device="cpu")
    assert len(opened) == 1 and srv.collections["a"].device.type == "cpu"
    assert srv.device.type == "cpu"
    close_all(srv)


def test_server_creates_collections_on_its_device(tmp_path):
    t = Pkg("torch")
    srv = t.make_server(tmp_path)
    httpd, base = start(srv, t.rest)
    try:
        assert make_coll(base)[0] == 201
        assert srv.collections["test"].device == srv.device
    finally:
        httpd.shutdown()
        close_all(srv)


# ---------------------------------------------------------------------------
# differential: one scripted sequence against both servers
# ---------------------------------------------------------------------------

N_DOCS, D = 600, 16


def _script(base, quant, metric):
    """A fixed sequence of requests -> [(label, status, body)]; bodies are
    parsed JSON with key order kept (lists of pairs) or raw text."""
    rng = np.random.default_rng(2024)
    vecs = rng.uniform(-1, 1, size=(N_DOCS, D))
    queries = rng.uniform(-1, 1, size=(6, D))
    out = []

    def call(label, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(
            base + "/api/v1" + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(r) as resp:
                code, raw = resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            code, raw = exc.code, exc.read()
        try:
            parsed = json.loads(raw, object_pairs_hook=list)
        except ValueError:
            parsed = raw.decode()
        out.append((label, code, parsed))

    call("create", "POST", "/collections", {
        "name": "d", "vector_size": D, "quantization": quant,
        "distance_function": metric})
    for a in (0, N_DOCS // 2):
        call(f"insert{a}", "POST", "/collections/d/records", [
            {"id": i, "vector": vecs[i].tolist(),
             "metadata": {"i": i, "kind": "odd" if i % 2 else "even",
                          "tags": ["t"] * (i % 3)}}
            for i in range(a, a + N_DOCS // 2)])
    call("info", "GET", "/collections/d")
    call("list", "GET", "/collections")
    for p in ("high", "exact", "medium", ""):
        for qi, q in enumerate(queries[:3]):
            body = {"vector": q.tolist(), "k": 10}
            if p:
                body["precision"] = p
            call(f"knn {p} {qi}", "POST", "/collections/d/search", body)
        call(f"filtered {p}", "POST", "/collections/d/search", {
            "vector": queries[3].tolist(), "k": 7, "precision": p,
            "filter": "i < 300 AND kind == 'odd'"})
        call(f"radius {p}", "POST", "/collections/d/search", {
            "vector": queries[4].tolist(), "radius": 0.3 if metric ==
            "cosine" else 2.2, "precision": p})
    call("k beyond n", "POST", "/collections/d/search",
         {"vector": queries[5].tolist(), "k": N_DOCS + 5,
          "precision": "high", "filter": "tags.length == 2"})
    call("list mode", "POST", "/collections/d/search",
         {"offset": 5, "limit": 7})
    call("list filtered", "POST", "/collections/d/search",
         {"filter": "kind == 'even'", "limit": 4, "offset": 2})
    call("get list", "GET", "/collections/d/search?limit=3&offset=10")
    call("bad filter", "POST", "/collections/d/search",
         {"vector": queries[0].tolist(), "k": 1, "filter": "=="})
    call("wrong dims", "POST", "/collections/d/search",
         {"vector": [0.1, 0.2], "k": 1})
    call("bad body", "POST", "/collections/d/search", None)
    call("no vector", "POST", "/collections/d/search", {"k": 3})
    call("missing", "POST", "/collections/nope/search",
         {"vector": queries[0].tolist(), "k": 1})
    call("put md", "PUT", "/collections/d/records/7/metadata",
         {"metadata": {"i": 7, "kind": "changed"}})
    call("put missing", "PUT", "/collections/d/records/9999/metadata",
         {"metadata": {}})
    call("del rec", "DELETE", "/collections/d/records/8")
    call("del rec again", "DELETE", "/collections/d/records/8")
    call("ids", "GET", "/collections/d/ids")
    call("after edits", "POST", "/collections/d/search",
         {"vector": vecs[7].tolist(), "k": 3, "precision": "high",
          "filter": "kind == 'changed' OR i == 9"})
    call("stray delete", "DELETE", "/collections/d/search")
    call("delete", "DELETE", "/collections/d")
    call("delete again", "DELETE", "/collections/d")
    return out, queries


def _keys(x):
    """The structure of a parsed body: key order at every level."""
    if isinstance(x, list) and x and all(
            isinstance(p, tuple) and len(p) == 2 for p in x):
        return [(k, _keys(v)) for k, v in x]
    if isinstance(x, list):
        return [_keys(v) for v in x]
    return type(x).__name__


def _surr(d, metric):
    d = np.asarray(d, dtype=np.float64)
    return d * d if metric == "euclidean" else (1.0 - np.cos(np.pi * d)) / 2


_TIMING = ("search_time", "queue_wait_time", "embedding_time")


@pytest.mark.parametrize("force_device", [False, True],
                         ids=["host_scan", "device_branch"])
@pytest.mark.parametrize("quant,metric", [(8, "cosine"), (64, "euclidean"),
                                          (8, "euclidean"), (64, "cosine")])
def test_differential_script(tmp_path, monkeypatch, quant, metric,
                             force_device):
    from syzgydb_tpu_torch.ops import scan

    runs = {}
    for name in ("jax", "torch"):
        p = Pkg(name)
        if force_device:
            monkeypatch.setattr(p.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
        folder = tmp_path / name
        folder.mkdir()
        monkeypatch.setattr(p.config, "global_config", p.config.Config(
            data_folder=str(folder), html_root=""))
        # a fixed random_seed: both packages then draw the same index seed
        # (stored in the options record, so storage_size matches) and
        # sample the same pairs for average_distance
        mr = p.config.my_random
        monkeypatch.setattr(mr, "_rng", mr._rng)
        monkeypatch.setattr(mr, "_seed", mr._seed)
        mr.seed(7)
        srv = p.make_server(folder)
        httpd, base = start(srv, p.rest)
        try:
            runs[name], queries = _script(base, quant, metric)
        finally:
            httpd.shutdown()
            close_all(srv)
    tol = 2 * scan.surface_accum_eps(D) * (
        1.0 if metric == "cosine" else D + float(np.sum(queries ** 2, 1).max()))
    searched = 0
    for (label, cj, bj), (_, ct, bt) in zip(runs["jax"], runs["torch"],
                                           strict=True):
        assert cj == ct, label
        if isinstance(bj, str):
            assert isinstance(bt, str), label
            continue
        assert _keys(bj) == _keys(bt), label
        if label == "ids":
            assert bj == bt
        if not (_is_obj(bj) and bj and bj[0][0] == "results"):
            assert bj == bt, label
            continue
        dj, dt = dict(bj), dict(bt)
        assert dj["percent_searched"] == dt["percent_searched"], label
        rj = [dict(r) for r in dj["results"]]
        rt = [dict(r) for r in dt["results"]]
        assert [r["id"] for r in rj] == [r["id"] for r in rt], label
        assert [r["metadata"] for r in rj] == [r["metadata"] for r in rt]
        np.testing.assert_allclose(
            _surr([r["distance"] for r in rt], metric),
            _surr([r["distance"] for r in rj], metric), rtol=0, atol=tol,
            err_msg=label)
        searched += bool(rj)
    assert searched >= 17


def _is_obj(x):
    return isinstance(x, list) and all(
        isinstance(p, tuple) and len(p) == 2 for p in x)


def test_folder_written_by_the_jax_server_serves_on_the_port(tmp_path,
                                                            monkeypatch):
    """The carried state: a data folder the JAX server wrote (created,
    filled and edited over HTTP) opens in the port's server, which answers
    the same searches with the same ids."""
    rng = np.random.default_rng(5)
    vecs = rng.uniform(-1, 1, size=(300, 8))
    qs = rng.uniform(-1, 1, size=(4, 8))
    searches = [{"vector": q.tolist(), "k": 5, "precision": p}
                for q in qs for p in ("high", "exact", "")] + [
        {"vector": qs[0].tolist(), "radius": 0.35, "precision": "high"},
        {"vector": qs[1].tolist(), "k": 4, "filter": "i >= 150"},
        {"offset": 3, "limit": 5}]
    answers = {}
    for name in ("jax", "torch"):
        p = Pkg(name)
        monkeypatch.setattr(p.config, "global_config", p.config.Config(
            data_folder=str(tmp_path), html_root=""))
        srv = p.make_server(tmp_path)
        httpd, base = start(srv, p.rest)
        try:
            if name == "jax":
                for coll, quant in (("c8", 8), ("c64", 64)):
                    assert make_coll(base, coll, 8, quant)[0] == 201
                    assert req(base, "POST", f"/api/v1/collections/{coll}"
                               "/records", [{"id": i, "vector": v.tolist(),
                                             "metadata": {"i": i}}
                                            for i, v in enumerate(vecs)]
                               )[0] == 201
                    req(base, "DELETE", f"/api/v1/collections/{coll}"
                        "/records/3")
                    req(base, "PUT", f"/api/v1/collections/{coll}/records/4"
                        "/metadata", {"metadata": {"i": 4, "x": 1}})
            else:
                assert sorted(srv.collections) == ["c64", "c8"]
            got = []
            for coll in ("c8", "c64"):
                code, info = req(base, "GET", f"/api/v1/collections/{coll}")
                got.append((code, info["document_count"],
                            info["quantization"]))
                for s in searches:
                    code, res = req(base, "POST",
                                    f"/api/v1/collections/{coll}/search", s)
                    got.append((code, [(r["id"], r["metadata"])
                                       for r in res["results"]],
                                res["percent_searched"]))
            answers[name] = got
        finally:
            httpd.shutdown()
            close_all(srv)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0] == (200, 299, 8)


# ---------------------------------------------------------------------------
# Collection members the server calls
# ---------------------------------------------------------------------------

def test_metadata_json_ok_matches_jax(tmp_path):
    out = {}
    for name in ("jax", "torch"):
        p = Pkg(name)
        row = {}
        for od in (False, True):
            c = p.Collection(p.db.CollectionOptions(
                name=str(tmp_path / f"{name}{od}.dat"), dimension_count=4,
                metadata_on_demand=od, create_and_overwrite=True))
            c.add_documents([1, 2, 3], np.eye(3, 4),
                            [b'{"a": 1}', b"{not json", b""])
            res = {r.id: r for r in c.search(p.db.SearchArgs(
                vector=[1, 0, 0, 0], k=3, precision="exact")).results}
            seq = [c.metadata_json_ok(res[i]) for i in (1, 2, 3)]
            seq.append(c.metadata_json_ok(res[1]))  # memoized
            # a rewritten row: the old result's bytes stay valid, the new
            # row's invalid bytes are not taken from the memo
            c.update_document(1, b"[broken")
            seq.append(c.metadata_json_ok(res[1]))
            new = c.search(p.db.SearchArgs(vector=[1, 0, 0, 0], k=1,
                                           precision="exact")).results[0]
            seq.append(c.metadata_json_ok(new))
            if not od:
                seq.append(bool(c.columns.meta_ok[c.columns._row_of[1]]))
            row[od] = seq
            c.close()
        out[name] = row
    assert out["torch"] == out["jax"]
    assert out["torch"][False] == [True, False, False, True, True, False,
                                   False]


def test_collection_stats_to_dict_keys(tmp_path):
    out = {}
    for name in ("jax", "torch"):
        p = Pkg(name)
        (tmp_path / name).mkdir()  # one file name: it is in the options
        c = p.Collection(p.db.CollectionOptions(
            name=str(tmp_path / name / "s.dat"), dimension_count=4,
            quantization=16, distance_method=p.db.COSINE, index_seed=5))
        c.add_documents([1, 2], np.eye(2, 4), [b"{}", b"{}"])
        d = c.compute_stats().to_dict()
        c.close()
        d.pop("average_distance")
        out[name] = list(d.items())
    assert out["torch"] == out["jax"]
    assert [k for k, _ in out["torch"]] == [
        "document_count", "dimension_count", "quantization",
        "distance_method", "storage_size"]


def test_batch_token_is_process_unique(tmp_path):
    t = Pkg("torch")
    tokens = []
    for i in range(3):
        c = t.Collection(t.db.CollectionOptions(
            name=str(tmp_path / f"{i}.dat"), dimension_count=2))
        tokens.append(c.batch_token)
        c.close()
        del c
    assert len(set(tokens)) == 3 and tokens == sorted(tokens)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_parses_serve_and_platform():
    from syzgydb_tpu_torch.tools import cli

    a = cli.build_parser().parse_args(
        ["--serve", "--platform", "cpu", "--data-folder", "/x",
         "--syzgy-host", "127.0.0.1:1", "--no-profiler"])
    assert (a.serve, a.platform, a.data_folder, a.syzgy_host,
            a.no_profiler) == (True, "cpu", "/x", "127.0.0.1:1", True)
    assert cli.build_parser().parse_args(["--serve"]).platform == "cuda"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--platform", "tpu"])


@pytest.mark.parametrize("verb,want_rc,want_out", [
    ("--dump", 0, "RECORD"), ("--export", 0, '"records": ['),
    ("--import", 0, "Imported into"),
    ("--import-ref", 0, "Imported 2 records"),
    ("--import-no-output", 2, ""), ("--import-ref-no-output", 2, "")])
def test_cli_tool_verbs(tmp_path, monkeypatch, capsys, verb, want_rc,
                        want_out):
    """Each tool verb runs with --platform cpu; --import and --import-ref
    without --output return 2 and write nothing."""
    import syzgydb_tpu_torch as tdb
    from syzgydb_tpu_torch.server import config as tcfg
    from syzgydb_tpu_torch.tools import cli, refimport

    monkeypatch.setattr(tcfg, "global_config", tcfg.global_config)
    src, out = tmp_path / "src.dat", tmp_path / "out.dat"
    c = tdb.Collection(tdb.CollectionOptions(
        name=str(src), dimension_count=3, quantization=8), device="cpu")
    c.add_documents([1, 2], np.eye(2, 3), [b'{"x": 1}', b"{}"])
    c.close()
    exp = tmp_path / "exp.json"
    exp.write_text('{"collection": {"dimension_count": 3}, "records": '
                   '[{"id": 4, "vector": [0, 1, 0], "metadata": {}}]}')
    ref = tmp_path / "ref.dat"
    ref.write_bytes(refimport.build_ref_file(
        {"dimension_count": 3, "quantization": 8}, [
            (1, np.ones(3), b"{}"), (2, np.zeros(3), b"{}")], 8))
    argv = {"--dump": ["--dump", str(src)],
            "--export": ["--export", str(src)],
            "--import": ["--import", str(exp), "--output", str(out)],
            "--import-ref": ["--import-ref", str(ref), "--output", str(out)],
            "--import-no-output": ["--import", str(exp)],
            "--import-ref-no-output": ["--import-ref", str(ref)]}[verb]
    capsys.readouterr()
    assert cli.main(argv + ["--platform", "cpu",
                            "--data-folder", str(tmp_path)]) == want_rc
    assert want_out in capsys.readouterr().out
    assert out.exists() == (verb in ("--import", "--import-ref"))


def test_cli_serve_without_platform_raises_on_a_host_without_cuda(
        tmp_path, monkeypatch):
    import torch
    from syzgydb_tpu_torch.server import config as tcfg
    from syzgydb_tpu_torch.server import rest as trest
    from syzgydb_tpu_torch.tools import cli

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setattr(tcfg, "global_config", tcfg.global_config)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trest, "run_server", lambda *a, **k: pytest.fail(
        "the server started"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--serve", "--data-folder", str(tmp_path / "d")])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(shutil.which("curl") is None or
                    shutil.which("bash") is None,
                    reason="needs curl and bash")
def test_testserver_script_against_the_cli_server_on_cpu(tmp_path):
    """`python -m syzgydb_tpu_torch.tools.cli --serve --platform cpu` in a
    child process, driven by scripts/testserver.sh."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "syzgydb_tpu_torch.tools.cli", "--serve",
         "--platform", "cpu", "--syzgy-host", f"127.0.0.1:{port}",
         "--data-folder", str(tmp_path / "data"), "--html-root", "",
         "--no-profiler"], cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/api/v1/collections",
                        timeout=2) as resp:
                    assert resp.status == 200
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        out = subprocess.run(
            ["bash", os.path.join(ROOT, "scripts", "testserver.sh"),
             f"127.0.0.1:{port}"], capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "smoke test passed" in out.stdout
        assert '"id":1' in out.stdout.replace(" ", "")
    finally:
        proc.terminate()
        proc.wait(timeout=30)

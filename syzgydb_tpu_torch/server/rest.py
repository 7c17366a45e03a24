"""REST API server.

Endpoint/JSON parity with the reference server (rest.go + main.go):

  POST   /api/v1/collections                     create (name, vector_size,
                                                 quantization, distance_function)
  GET    /api/v1/collections                     list w/ stats, doc-count desc
  GET    /api/v1/collections/{c}                 stats
  DELETE /api/v1/collections/{c}                 delete (200 even if missing,
                                                 rest.go:190-195)
  GET    /api/v1/collections/{c}/ids             all document ids
  POST   /api/v1/collections/{c}/records         bulk insert (array body;
                                                 text->vector via one batched
                                                 embed_text call, rest.go:221-292)
  PUT    /api/v1/collections/{c}/records/{id}/metadata
  DELETE /api/v1/collections/{c}/records/{id}
  GET|POST /api/v1/collections/{c}/search        -> {results, percent_searched,
                                                 search_time, embedding_time}

Collections live as {data_folder}/{name}.dat; startup re-opens every *.dat
(main.go:16-34).  Responses gzip when the client accepts it (rest.go:25-38);
static files served from html_root.  Implementation is stdlib http.server —
the compute path is on-device, the HTTP layer just routes.

The endpoints, JSON, status codes and response framing are the JAX
package's (``syzgydb_tpu/server/rest.py``).  The server's device is resolved
once, at construction: CUDA unless the caller passes ``device="cpu"``, and a
server asked for CUDA on a host without a card raises before it opens any
collection.  Every collection it creates or reopens lives on that device.
"""

from __future__ import annotations

import glob
import gzip
import io
import json
import logging
import mimetypes
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..core.collection import (Collection, CollectionOptions, SearchArgs,
                               COSINE, EUCLIDEAN, resolve_device)
from ..core import capacity as capacity_mod
from .. import build_filter
from . import config, embedding

log = logging.getLogger("syzgydb.rest")

_GZIP_TYPES = ("application/json", "text", "text/html", "text/css",
               "application/javascript", "image/svg+xml")


class Server:
    """Collection registry (rest.go:20-23)."""

    def __init__(self, data_folder: Optional[str] = None, device=None):
        from .batcher import SearchBatcher
        # resolved first: a CUDA server on a host without a card raises
        # here, before any collection is opened
        self.device = resolve_device(device)
        self.collections: dict[str, Collection] = {}
        self.mutex = threading.Lock()
        self.data_folder = data_folder or config.global_config.data_folder
        # concurrent single-query searches coalesce into one device batch
        self.batcher = SearchBatcher(
            window_s=config.global_config.search_batch_ms / 1000.0)

    def collection_file(self, name: str) -> str:
        return os.path.join(self.data_folder, name + ".dat")

    @staticmethod
    def file_to_collection_name(path: str) -> str:
        base = os.path.basename(path)
        return base[:-4] if base.endswith(".dat") else base

    def get(self, name: str) -> Optional[Collection]:
        with self.mutex:
            return self.collections.get(name)

    def stats_with_name(self, name: str, coll: Collection) -> dict:
        d = coll.compute_stats().to_dict()
        d["name"] = name
        return d


def _open_existing(path: str) -> CollectionOptions:
    # dimension_count comes from the stored options record; pass a
    # placeholder that merge_from_json overrides (collection.go:241-252)
    return CollectionOptions(name=path, dimension_count=1)


class _FastHeaders:
    """Minimal case-insensitive header map for the hot request path —
    replaces http.client.parse_headers' email.feedparser machinery, which
    cost ~0.1 ms/request on the JAX package's serving profile.
    Supports the access patterns this server uses (.get / in / [])."""

    __slots__ = ("_d",)

    def __init__(self, d: dict):
        self._d = d

    def get(self, name, default=None):
        return self._d.get(name.lower(), default)

    def __contains__(self, name) -> bool:
        return name.lower() in self._d

    def __getitem__(self, name):
        v = self._d.get(name.lower())
        if v is None:
            raise KeyError(name)
        return v


class _Handler(BaseHTTPRequestHandler):
    server_version = "syzgydb-tpu/0.1"
    # HTTP/1.1 keep-alive: every response path goes through _respond, which
    # always sends Content-Length, so persistent connections are safe.  The
    # stdlib default (1.0, close-per-request) made each benchmark request
    # pay a TCP handshake + a fresh handler thread — ~keep-alive is also
    # what the reference's net/http server does by default.
    protocol_version = "HTTP/1.1"
    srv: Server  # injected

    # -- plumbing ----------------------------------------------------------

    def parse_request(self) -> bool:
        """Fast-path request parsing for the common serving shape
        (HTTP/1.0-1.1, plain single-line headers).  An unusual request
        line delegates to the stdlib parser before any header bytes are
        consumed; malformed or oversized headers get the stdlib's error
        replies.  Cuts the email.feedparser header machinery (~0.1 ms per
        request on the JAX package's single-core profile)."""
        try:
            line = self.raw_requestline.decode("iso-8859-1").rstrip("\r\n")
            command, path, version = line.split(" ")
            if version not in ("HTTP/1.1", "HTTP/1.0"):
                raise ValueError
        except ValueError:
            return super().parse_request()
        self.requestline = line
        self.command, self.path, self.request_version = \
            command, path, version
        self.close_connection = version == "HTTP/1.0"
        d: dict[str, str] = {}
        last = None
        last_stored = False
        while True:
            h = self.rfile.readline(65537)
            if len(h) > 65536:
                self.send_error(431)
                return False
            if h in (b"\r\n", b"\n", b""):
                break
            if len(d) >= 100:
                self.send_error(431)
                return False
            s = h.decode("iso-8859-1")
            if s[:1] in (" ", "\t") and last is not None:
                # obs-fold continuation — but only onto a header we kept:
                # a fold after a DISCARDED duplicate belongs to that
                # duplicate's value and must be discarded with it, not
                # appended to the first occurrence
                if last_stored:
                    d[last] += " " + s.strip()
                continue
            k, sep, v = s.partition(":")
            if not sep:
                self.send_error(400, "Bad request header")
                return False
            last = k.strip().lower()
            # FIRST occurrence wins, matching the stdlib email parser's
            # Message.get (a duplicated Content-Length must not change
            # request framing relative to the fallback parser)
            last_stored = last not in d
            if last_stored:
                d[last] = v.strip()
        self.headers = _FastHeaders(d)
        conn = (d.get("connection") or "").lower()
        if conn == "close":
            self.close_connection = True
        elif conn == "keep-alive":
            self.close_connection = False
        if version == "HTTP/1.1" and \
                (d.get("expect") or "").lower() == "100-continue":
            if not self.handle_expect_100():
                return False
        return True

    def log_message(self, fmt, *args):  # route through logging
        log.info("%s " + fmt, self.address_string(), *args)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        self._body_read = True
        return self.rfile.read(length) if length else b""

    def _respond(self, code: int, payload, pretty: bool = False,
                 content_type: str = "application/json") -> None:
        # keep-alive safety: an early-error path that
        # never read the request body would leave its bytes in the socket,
        # and the NEXT request on this persistent connection would parse
        # them as a request line.  Drain small unread bodies; close the
        # connection instead of draining huge ones.
        length = int(self.headers.get("Content-Length") or 0)
        if length and not getattr(self, "_body_read", False):
            if length <= (1 << 20):
                self.rfile.read(length)
            else:
                self.close_connection = True
            self._body_read = True
        if isinstance(payload, (dict, list)):
            body = json.dumps(payload, indent=2 if pretty else None).encode()
            body += b"\n"
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = payload
        accept = self.headers.get("Accept-Encoding", "")
        use_gzip = "gzip" in accept and any(
            content_type.startswith(t) for t in _GZIP_TYPES) and len(body) > 200
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if use_gzip:
            buf = io.BytesIO()
            with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
                gz.write(body)
            body = buf.getvalue()
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, message: str, code: int) -> None:
        log.warning("Error: %s, Status Code: %d", message, code)
        self._respond(code, message + "\n", content_type="text/plain")

    # -- routing -----------------------------------------------------------

    def _route(self) -> None:
        self._body_read = False  # handler instance persists across requests
        path = self.path.split("?")[0].rstrip()
        parts = path.split("/")
        try:
            if path == "/api/v1/collections":
                return self._handle_collections()
            if path.startswith("/api/v1/collections/"):
                if path.endswith("/records") and self.command == "POST":
                    return self._handle_insert(parts)
                if "/records/" in path and self.command == "PUT":
                    return self._handle_update_metadata(parts)
                if "/records/" in path and self.command == "DELETE":
                    return self._handle_delete_record(parts)
                if path.endswith("/search") and self.command in ("GET", "POST"):
                    return self._handle_search(parts)
                return self._handle_collection(parts)
            if self.command == "GET":
                return self._serve_static(path)
            self._error("Not found", 404)
        except BrokenPipeError:
            pass
        except Exception as exc:  # robustness: surface as 500, keep serving
            log.exception("handler error")
            self._error(f"Internal error: {exc}", 500)

    do_GET = do_POST = do_PUT = do_DELETE = _route

    # -- handlers ----------------------------------------------------------

    def _handle_collections(self) -> None:
        if self.command == "POST":
            try:
                req = json.loads(self._body())
            except json.JSONDecodeError:
                return self._error("Invalid request body", 400)
            name = req.get("name", "")
            if not name or not all(c.isalnum() or c in "._-" for c in name) \
                    or name.startswith(".") or os.sep in name:
                # the name becomes a filename under data_folder: separators,
                # absolute paths and dot-prefixes must never escape it
                return self._error("Invalid collection name", 400)
            dm = req.get("distance_function", "")
            if dm == "euclidean":
                method = EUCLIDEAN
            elif dm == "cosine":
                method = COSINE
            else:
                return self._error("Invalid distance method", 400)
            # reserve the name under the mutex, construct OUTSIDE it:
            # Collection() touches disk (and possibly the device), and one
            # slow create must not stall every other request on the server
            with self.srv.mutex:
                if name in self.srv.collections:
                    return self._error("Collection already exists", 400)
                self.srv.collections[name] = None  # reservation
            opts = CollectionOptions(
                name=self.srv.collection_file(name),
                distance_method=method,
                dimension_count=int(req.get("vector_size", 0)),
                quantization=int(req.get("quantization", 0) or 64))
            # tuning knobs (superset of the reference API)
            for knob in ("search_budget", "index_tables",
                         "index_bits_per_table"):
                if knob in req:
                    setattr(opts, knob, int(req[knob]))
            if req.get("metadata_on_demand"):
                opts.metadata_on_demand = True  # out-of-core metadata
            try:
                coll = Collection(opts, device=self.srv.device)
            except ValueError as exc:
                # bad options are the caller's fault; Collection validates
                # before creating the file, so nothing is left behind and a
                # corrected retry succeeds
                with self.srv.mutex:
                    self.srv.collections.pop(name, None)
                return self._error(
                    f"Failed to create collection: {exc}", 400)
            except Exception as exc:
                with self.srv.mutex:
                    self.srv.collections.pop(name, None)
                return self._error(
                    f"Failed to create collection: {exc}", 500)
            with self.srv.mutex:
                self.srv.collections[name] = coll
            return self._respond(201, {
                "message": "Collection created successfully.",
                "collection_name": name})
        if self.command == "GET":
            with self.srv.mutex:
                items = [(n, c) for n, c in self.srv.collections.items()
                         if c is not None]  # skip in-flight reservations
            infos = [self.srv.stats_with_name(n, c) for n, c in items]
            infos.sort(key=lambda d: -d["document_count"])
            return self._respond(200, infos, pretty=True)
        self._error("Method not allowed", 405)

    def _get_collection(self, parts) -> Optional[tuple[str, Collection]]:
        if len(parts) < 5:
            self._error("Invalid path", 400)
            return None
        name = parts[4]
        coll = self.srv.get(name)
        if coll is None:
            if self.command == "DELETE":
                self._respond(200, {"message": "Collection did not exist."})
                return None
            self._error("Collection not found", 404)
            return None
        return name, coll

    def _handle_collection(self, parts) -> None:
        # reject stray sub-paths: without this, DELETE .../{c}/search would
        # fall through and delete the collection (a reference router
        # fall-through we deliberately do NOT reproduce, main.go:36-50)
        if len(parts) > 5 and not (self.command == "GET" and len(parts) == 6
                                   and parts[5] == "ids"):
            return self._error("Not found", 404)
        got = self._get_collection(parts)
        if got is None:
            return
        name, coll = got
        if self.command == "GET":
            if len(parts) == 6 and parts[5] == "ids":
                return self._respond(200, coll.get_all_ids())
            return self._respond(200, self.srv.stats_with_name(name, coll))
        if self.command == "DELETE":
            with self.srv.mutex:
                self.srv.collections.pop(name, None)
            coll.close()
            try:
                os.remove(self.srv.collection_file(name))
            except FileNotFoundError:
                pass
            return self._respond(200,
                                 {"message": "Collection deleted successfully."})
        self._error("Method not allowed", 405)

    def _handle_insert(self, parts) -> None:
        got = self._get_collection(parts)
        if got is None:
            return
        _, coll = got
        try:
            records = json.loads(self._body())
            assert isinstance(records, list)
        except (json.JSONDecodeError, AssertionError):
            return self._error("Invalid request body", 400)

        if not all(isinstance(r, dict) for r in records):
            return self._error("Invalid request body", 400)
        texts, text_idx = [], []
        for i, rec in enumerate(records):
            if rec.get("text") and rec.get("vector") is None:
                text_idx.append(i)
                texts.append(rec["text"])
        if texts:
            try:
                # one batched call; inserts don't populate the cache
                # (rest.go:262, embedding.go:29-48)
                vectors = embedding.embed_text(texts, False)
            except Exception as exc:
                return self._error(
                    f"Failed to convert text to vector: {exc}", 500)
            for j, i in enumerate(text_idx):
                records[i]["vector"] = vectors[j]

        ids, vecs, metas = [], [], []
        for rec in records:
            if rec.get("vector") is None:
                return self._error("Either vector or text must be provided",
                                   400)
            ids.append(int(rec.get("id", 0)))
            vecs.append(rec["vector"])
            metas.append(json.dumps(rec.get("metadata") or {}).encode())
        try:
            coll.add_documents(ids, vecs, metas)
        except ValueError as exc:
            return self._error(str(exc), 400)
        except capacity_mod.CapacityError as exc:
            # capacity preflight (core/capacity.py): nothing was written —
            # 507 Insufficient Storage with the actionable message.  A
            # bare MemoryError from deeper in the allocator deliberately
            # stays on the generic 500 path: it carries no
            # nothing-was-written guarantee
            return self._error(str(exc), 507)
        self._respond(201, {"message": "Records inserted successfully."})

    def _handle_update_metadata(self, parts) -> None:
        got = self._get_collection(parts)
        if got is None:
            return
        _, coll = got
        try:
            doc_id = int(parts[-2])
        except ValueError:
            return self._error("Invalid record ID", 400)
        try:
            body = json.loads(self._body())
            metadata = json.dumps(body.get("metadata") or {}).encode()
        except json.JSONDecodeError:
            return self._error("Invalid request body", 400)
        try:
            coll.update_document(doc_id, metadata)
        except KeyError:
            return self._error("Record not found", 404)
        self._respond(200, {"message": "Metadata updated successfully.",
                            "id": doc_id})

    def _handle_delete_record(self, parts) -> None:
        got = self._get_collection(parts)
        if got is None:
            return
        _, coll = got
        try:
            doc_id = int(parts[6])
        except (IndexError, ValueError):
            return self._error("Invalid record ID", 400)
        try:
            coll.remove_document(doc_id)
        except KeyError:
            return self._error("Record not found", 404)
        self._respond(200, {"message": "Record deleted successfully.",
                            "id": doc_id})

    def _handle_search(self, parts) -> None:
        got = self._get_collection(parts)
        if got is None:
            return
        _, coll = got
        args = SearchArgs()
        text = ""
        filter_str = ""
        if self.command == "GET":
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)

            def one(key, default=""):
                return q.get(key, [default])[0]

            def num(key, cast):
                try:  # unparseable values fall back to 0, matching the
                    # reference's ignored Atoi errors (rest.go:403-409)
                    return cast(one(key) or 0)
                except ValueError:
                    return cast(0)
            args.offset = num("offset", int)
            args.limit = num("limit", int)
            args.radius = num("radius", float)
            args.k = num("k", int)
            args.precision = one("precision")
            text = one("text")
            filter_str = one("filter")
            # NOTE: GET cannot pass a vector — reference quirk (rest.go:401-409)
        else:
            try:
                req = json.loads(self._body())
            except json.JSONDecodeError:
                return self._error("Invalid request body", 400)
            args.vector = req.get("vector")
            args.offset = int(req.get("offset") or 0)
            args.limit = int(req.get("limit") or 0)
            args.radius = float(req.get("radius") or 0)
            args.k = int(req.get("k") or 0)
            args.precision = req.get("precision") or ""
            text = req.get("text") or ""
            filter_str = req.get("filter") or ""

        if filter_str:
            try:
                build_filter(filter_str)  # validate syntax for the 400 path
            except Exception as exc:
                return self._error(f"Invalid filter query: {exc}", 400)
            # pass the string through so the collection can cache the mask
            args.filter_query = filter_str

        embedding_ms = 0
        if text:
            t0 = time.perf_counter()
            try:
                # searches use the cache (rest.go:441)
                vectors = embedding.embed_text([text], True)
            except Exception as exc:
                return self._error(
                    f"Failed to convert text to vector: {exc}", 500)
            args.vector = vectors[0]
            embedding_ms = int((time.perf_counter() - t0) * 1000)

        t0 = time.perf_counter()
        try:
            results = self.srv.batcher.search(coll, args)
        except ValueError as exc:
            return self._error(str(exc), 400)
        total_ms = (time.perf_counter() - t0) * 1000.0
        # search_time keeps the reference's semantics — the Collection
        # search dispatch alone (rest.go:450-452).  Under batching that is
        # the group's shared device dispatch; the coalescing-window wait is
        # reported separately as queue_wait_time so a client comparing
        # implementations never sees batching latency booked as search time.
        search_ms = int(results.search_time_ms)
        queue_ms = int(max(0.0, total_ms - results.search_time_ms))

        # Response assembly splices each result's STORED metadata bytes
        # verbatim (they are already JSON) instead of parse + re-serialize
        # per result (the reference re-unmarshals every result,
        # rest.go:453-461).  Validity is memoized per row
        # (Collection.metadata_json_ok); invalid metadata skips the result
        # with a warning, exactly like the reference.  The byte layout
        # matches json.dumps' default separators, so clients see an
        # identical response shape.
        parts = [b'{"results": [']
        first = True
        for r in results.results:
            if not r.metadata:
                md = b"{}"
            elif coll.metadata_json_ok(r):
                md = r.metadata
            else:
                log.warning("Error decoding metadata for ID %d", r.id)
                continue
            parts.append(
                (f'{"" if first else ", "}{{"id": {r.id}, '
                 f'"metadata": ').encode())
            parts.append(md)
            parts.append(f', "distance": {float(r.distance)!r}}}'.encode())
            first = False
        parts.append(
            (f'], "percent_searched": {float(results.percent_searched)!r}, '
             f'"search_time": {search_ms}, '
             f'"queue_wait_time": {queue_ms}, '
             f'"embedding_time": {embedding_ms}}}\n').encode())
        self._respond(200, b"".join(parts))

    # -- static files ------------------------------------------------------

    def _serve_static(self, path: str) -> None:
        root = config.global_config.html_root
        if not root:
            return self._error("Not found", 404)
        rel = path.lstrip("/") or "index.html"
        full = os.path.realpath(os.path.join(root, rel))
        rootreal = os.path.realpath(root)
        # commonpath, not startswith: "html_private" must not pass as being
        # under the "html" root (bare-prefix traversal)
        try:
            inside = os.path.commonpath([full, rootreal]) == rootreal
        except ValueError:
            inside = False
        if not inside:
            return self._error("Forbidden", 403)
        if os.path.isdir(full):
            full = os.path.join(full, "index.html")
        if not os.path.isfile(full):
            return self._error("Not found", 404)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            self._respond(200, f.read(), content_type=ctype)


def _server_mesh() -> None:
    """use_mesh=auto: a no-op on fewer than two CUDA devices; on two or more
    it raises, as multi-device placement is not ported yet."""
    if config.global_config.use_mesh != "auto":
        return None
    if torch.cuda.device_count() < 2:
        return None
    raise NotImplementedError(
        "use_mesh=auto over several CUDA devices is not ported yet "
        "(ROADMAP.md Queue 1, item 4: Multi-GPU)")


def make_server(data_folder: Optional[str] = None,
                load_existing: bool = True, device=None) -> Server:
    srv = Server(data_folder, device=device)
    _server_mesh()
    if config.global_config.embedder == "device":
        # never falls back to the Ollama client in its place
        raise NotImplementedError(
            "embedder=device is not ported yet (ROADMAP.md Queue 1, item 3: "
            "Embedder)")
    if load_existing:
        for path in glob.glob(os.path.join(srv.data_folder, "*.dat")):
            name = srv.file_to_collection_name(path)
            log.info("Loading collection from file: %s", path)
            try:
                coll = Collection(_open_existing(path), device=srv.device)
                srv.collections[name] = coll
            except Exception:
                # one bad/corrupt .dat must not take the whole server
                # down; skip it and keep serving the others
                log.exception("Failed to load collection %s; skipping", path)
    return srv


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib default listen backlog of 5 RESETS connections under the
    # very burst traffic the search batcher exists to serve
    request_queue_size = 128


def run_server(srv: Optional[Server] = None,
               host_port: Optional[str] = None) -> None:
    """RunServer analog (main.go:10-63); blocks."""
    srv = srv or make_server()
    hp = host_port or config.global_config.syzgy_host
    host, _, port = hp.rpartition(":")
    handler = type("BoundHandler", (_Handler,), {"srv": srv})
    httpd = _HTTPServer((host or "0.0.0.0", int(port)), handler)
    log.info("Starting server on %s", hp)
    httpd.serve_forever()


def make_http_server(srv: Server, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Non-blocking variant for tests; returns the bound server object."""
    handler = type("BoundHandler", (_Handler,), {"srv": srv})
    return _HTTPServer((host, port), handler)

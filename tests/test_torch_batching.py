"""Search micro-batching on both packages, on the CPU: the flows of
tests/test_batching.py run against the JAX package's Collection and
SearchBatcher and against the port's (syzgydb_tpu_torch, device="cpu"),
and the port's batched results must equal its own sequential ones.

The windows, margins and assertions are the JAX tests' (a 50 ms window,
`dispatches < queries` rather than exact group sizes), so a slow host makes
groups smaller, never a test fail.  The JAX package's mesh case has no
counterpart: the port refuses multi-device placement
(tests/test_torch_rest.py holds the server's refusal)."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
from test_torch_rest import Pkg


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return Pkg(request.param)


def make_coll(pkg, tmp_path, rng, n=600, dims=16, **kw):
    c = pkg.db.Collection(pkg.db.CollectionOptions(
        name=str(tmp_path / "b.dat"), distance_method=pkg.db.COSINE,
        dimension_count=dims, quantization=8, create_and_overwrite=True,
        index_seed=13, **kw), **pkg.kw)
    vecs = rng.uniform(-1, 1, size=(n, dims))
    c.add_documents(list(range(n)), vecs, [
        json.dumps({"i": i}).encode() for i in range(n)])
    return c, vecs


def Args(pkg, **kw):
    return pkg.db.SearchArgs(**kw)


def run_threads(n, fn):
    errors = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "wedged waiters"
    return errors


@pytest.mark.parametrize("precision", ["exact", "medium", "high"])
@pytest.mark.parametrize("force_device", [False, True])
def test_search_many_matches_sequential(pkg, tmp_path, rng, monkeypatch,
                                        precision, force_device):
    if force_device:
        monkeypatch.setattr(pkg.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
    c, _ = make_coll(pkg, tmp_path, rng)
    queries = rng.uniform(-1, 1, size=(7, 16))
    batch = c.search_many([Args(pkg, vector=q, k=5, precision=precision)
                           for q in queries])
    seq = [c.search(Args(pkg, vector=q, k=5, precision=precision))
           for q in queries]
    assert len(batch) == len(seq)
    for b, s in zip(batch, seq):
        assert [r.id for r in b.results] == [r.id for r in s.results]
        np.testing.assert_allclose([r.distance for r in b.results],
                                   [r.distance for r in s.results],
                                   rtol=1e-5, atol=1e-6)
        assert b.percent_searched == s.percent_searched
    c.close()


def test_search_many_with_filter_query(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng)
    queries = rng.uniform(-1, 1, size=(4, 16))
    fq = "i < 100"
    batch = c.search_many([Args(pkg, vector=q, k=3, filter_query=fq)
                           for q in queries])
    for q, b in zip(queries, batch):
        s = c.search(Args(pkg, vector=q, k=3, filter_query=fq))
        assert [r.id for r in b.results] == [r.id for r in s.results]
        assert all(r.id < 100 for r in b.results)
    c.close()


def test_search_many_rejects_heterogeneous(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng, n=20)
    q = rng.uniform(-1, 1, size=16)
    for group in ([Args(pkg, vector=q, k=3), Args(pkg, vector=q, k=4)],
                  [Args(pkg, vector=q, k=3),
                   Args(pkg, vector=q, k=3, radius=0.5)],
                  [Args(pkg, vector=q, k=3, precision="exact"),
                   Args(pkg, vector=q, k=3, precision="medium")]):
        with pytest.raises(ValueError):
            c.search_many(group)
    c.close()


def test_batcher_coalesces_concurrent_searches(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng)
    batcher = pkg.batcher.SearchBatcher(window_s=0.05)
    queries = rng.uniform(-1, 1, size=(16, 16))
    seq = [c.search(Args(pkg, vector=q, k=5)) for q in queries]
    results = [None] * len(queries)

    def worker(i):
        results[i] = batcher.search(c, Args(pkg, vector=queries[i], k=5))

    assert not run_threads(len(queries), worker)
    for got, want in zip(results, seq):
        assert [r.id for r in got.results] == [r.id for r in want.results]
    assert batcher.dispatches < batcher.queries == len(queries)
    c.close()


@pytest.mark.parametrize("precision", ["exact", "high", "medium"])
@pytest.mark.parametrize("force_device", [False, True])
def test_radius_many_matches_sequential(pkg, tmp_path, rng, monkeypatch,
                                        precision, force_device):
    if force_device:
        monkeypatch.setattr(pkg.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
    c, _ = make_coll(pkg, tmp_path, rng)
    queries = rng.uniform(-1, 1, size=(5, 16))
    radii = [0.2, 0.35, 0.5, 0.2, 0.05]
    args = [Args(pkg, vector=q, radius=r, precision=precision)
            for q, r in zip(queries, radii)]
    batch = c.radius_many(args)
    for a, b in zip(args, batch):
        s = c.search(Args(pkg, vector=a.vector, radius=a.radius,
                          precision=precision))
        assert [r.id for r in b.results] == [r.id for r in s.results]
        np.testing.assert_allclose([r.distance for r in b.results],
                                   [r.distance for r in s.results],
                                   rtol=1e-5, atol=1e-6)
        assert all(r.distance <= a.radius for r in b.results)
    c.close()


def test_radius_many_with_filter_query(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng)
    queries = rng.uniform(-1, 1, size=(3, 16))
    fq = "i >= 200"
    batch = c.radius_many([Args(pkg, vector=q, radius=0.4, filter_query=fq)
                           for q in queries])
    for q, b in zip(queries, batch):
        s = c.search(Args(pkg, vector=q, radius=0.4, filter_query=fq))
        assert [r.id for r in b.results] == [r.id for r in s.results]
        assert all(r.id >= 200 for r in b.results)
    c.close()


def test_radius_many_rejects_heterogeneous(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng, n=20)
    q = rng.uniform(-1, 1, size=16)
    with pytest.raises(ValueError):
        c.radius_many([Args(pkg, vector=q, radius=0.5),
                       Args(pkg, vector=q, k=3)])
    with pytest.raises(ValueError):
        c.radius_many([Args(pkg, vector=q, radius=0.5, precision="exact"),
                       Args(pkg, vector=q, radius=0.5)])
    c.close()


def test_batcher_coalesces_concurrent_radius_searches(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng)
    batcher = pkg.batcher.SearchBatcher(window_s=0.05)
    queries = rng.uniform(-1, 1, size=(12, 16))
    radii = [0.15 + 0.05 * (i % 4) for i in range(len(queries))]
    seq = [c.search(Args(pkg, vector=q, radius=r))
           for q, r in zip(queries, radii)]
    results = [None] * len(queries)

    def worker(i):
        results[i] = batcher.search(
            c, Args(pkg, vector=queries[i], radius=radii[i]))

    assert not run_threads(len(queries), worker)
    for got, want, r in zip(results, seq, radii):
        assert [x.id for x in got.results] == [x.id for x in want.results]
        assert all(x.distance <= r for x in got.results)
    assert batcher.dispatches < batcher.queries == len(queries)
    c.close()


def test_batcher_lone_query_no_window_wait(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng, n=50)
    batcher = pkg.batcher.SearchBatcher(window_s=5.0)
    q = rng.uniform(-1, 1, size=16)
    t0 = time.perf_counter()
    res = batcher.search(c, Args(pkg, vector=q, k=3))
    assert time.perf_counter() - t0 < 2.0
    assert len(res.results) == 3
    c.close()


def test_batcher_bypasses_malformed_vectors_and_list_mode(pkg, tmp_path,
                                                          rng):
    """A wrong-length vector fails its own request (ValueError), and a
    list-mode query (no k, no radius) bypasses the batcher."""
    c, _ = make_coll(pkg, tmp_path, rng, n=30)
    batcher = pkg.batcher.SearchBatcher(window_s=0.05)
    with pytest.raises(ValueError):
        batcher.search(c, Args(pkg, vector=[0.1, 0.2], k=3))
    res = batcher.search(c, Args(pkg, limit=4))
    assert [r.id for r in res.results] == [0, 1, 10, 11]
    assert batcher.dispatches == 0
    c.close()


def test_rest_concurrent_searches_batched(pkg, tmp_path, rng):
    srv = pkg.Server(tmp_path)
    srv.batcher.window_s = 0.05
    c, _ = make_coll(pkg, tmp_path, rng, n=400)
    srv.collections["b"] = c
    httpd = pkg.rest.make_http_server(srv)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        queries = rng.uniform(-1, 1, size=(12, 16))
        want = [[r.id for r in c.search(Args(pkg, vector=q, k=4)).results]
                for q in queries]
        got = [None] * len(queries)

        def hit(i):
            body = json.dumps({"vector": queries[i].tolist(),
                               "k": 4}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v1/collections/b/search",
                data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                got[i] = [r["id"] for r in
                          json.loads(resp.read())["results"]]

        assert not run_threads(len(queries), hit)
        assert got == want
        assert srv.batcher.dispatches < srv.batcher.queries
    finally:
        httpd.shutdown()
        c.close()


def test_batcher_dispatch_failure_wakes_all_members(pkg, tmp_path, rng,
                                                    monkeypatch):
    c, _ = make_coll(pkg, tmp_path, rng, n=50)
    batcher = pkg.batcher.SearchBatcher(window_s=0.05)
    boom = RuntimeError("device fell over")

    def exploding_search_many(args_list):
        raise boom

    monkeypatch.setattr(c, "search_many", exploding_search_many)
    q = rng.uniform(-1, 1, size=16)
    errors = [None] * 8

    def worker(i):
        try:
            batcher.search(c, Args(pkg, vector=q, k=3))
        except BaseException as exc:
            errors[i] = exc

    run_threads(8, worker)

    def is_boom(e):
        return isinstance(e, RuntimeError) and str(e) == str(boom) and \
            (e is boom or e.__cause__ is boom)
    assert all(e is None or is_boom(e) for e in errors)
    assert any(is_boom(e) for e in errors)
    monkeypatch.undo()
    res = batcher.search(c, Args(pkg, vector=q, k=3))
    assert len(res.results) == 3
    c.close()


def test_batcher_overflow_splits_groups(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng, n=100)
    batcher = pkg.batcher.SearchBatcher(window_s=0.05, max_batch=4)
    q = rng.uniform(-1, 1, size=16)
    want = [r.id for r in c.search(Args(pkg, vector=q, k=3)).results]
    results = [None] * 14

    def worker(i):
        results[i] = batcher.search(c, Args(pkg, vector=q, k=3))

    assert not run_threads(14, worker)
    assert all([x.id for x in r.results] == want for r in results)
    assert batcher.dispatches >= 4  # 14 queries / max_batch 4
    c.close()


def _spy_fetch_and_dispatch(pkg, monkeypatch, sleep_s):
    events = []
    ev_lock = threading.Lock()

    def note(tag):
        with ev_lock:
            events.append((tag, time.monotonic()))

    Coll = pkg.db.Collection
    orig_fetch = Coll._fetch_results

    def slow_fetch(*a, **kw):
        note("fetch_start")
        time.sleep(sleep_s)
        out = orig_fetch(*a, **kw)
        note("fetch_end")
        return out

    monkeypatch.setattr(Coll, "_fetch_results", staticmethod(slow_fetch))
    orig_topk = Coll._exact_topk_device

    def spying_topk(self, *a, **kw):
        note("dispatch")
        return orig_topk(self, *a, **kw)

    monkeypatch.setattr(Coll, "_exact_topk_device", spying_topk)
    return events, note


def test_dispatch_fetch_overlap(pkg, tmp_path, rng, monkeypatch):
    """Group N+1's device dispatch starts while group N's result fetch is
    in flight: the collection lock covers the enqueue, not the fetch."""
    monkeypatch.setattr(pkg.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
    c, _ = make_coll(pkg, tmp_path, rng, n=512, dims=16)
    events, _ = _spy_fetch_and_dispatch(pkg, monkeypatch, 0.2)
    queries = rng.uniform(-1, 1, size=(8, 16))
    args = [Args(pkg, vector=q, k=3, precision="high") for q in queries]
    errs = []

    def run_group():
        try:
            c.search_many(args)
        except BaseException as exc:  # pragma: no cover
            errs.append(exc)

    ta = threading.Thread(target=run_group)
    tb = threading.Thread(target=run_group)
    ta.start()
    time.sleep(0.05)
    tb.start()
    ta.join()
    tb.join()
    assert not errs, errs
    dispatches = [t for tag, t in events if tag == "dispatch"]
    fetch_ends = [t for tag, t in events if tag == "fetch_end"]
    assert len(dispatches) == 2 and len(fetch_ends) == 2, events
    assert sorted(dispatches)[1] < min(fetch_ends), events
    c.close()


def test_radius_dispatch_fetch_overlap(pkg, tmp_path, rng, monkeypatch):
    """A mutation completes inside a radius group's fetch window instead of
    waiting it out."""
    monkeypatch.setattr(pkg.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
    c, _ = make_coll(pkg, tmp_path, rng, n=512, dims=16)
    events, note = _spy_fetch_and_dispatch(pkg, monkeypatch, 0.3)
    errs = []
    qs = rng.uniform(-1, 1, size=(4, 16))

    def radius_group():
        try:
            c.radius_many([Args(pkg, vector=q, radius=0.5, precision="high")
                           for q in qs])
        except BaseException as exc:  # pragma: no cover
            errs.append(exc)

    def mutate():
        try:
            time.sleep(0.1)
            c.add_document(9000, np.zeros(16), b"{}")
            note("mutation_done")
        except BaseException as exc:  # pragma: no cover
            errs.append(exc)

    ta = threading.Thread(target=radius_group)
    tb = threading.Thread(target=mutate)
    ta.start()
    tb.start()
    ta.join()
    tb.join()
    assert not errs, errs
    fetch_ends = [t for tag, t in events if tag == "fetch_end"]
    done = [t for tag, t in events if tag == "mutation_done"]
    assert done and fetch_ends, events
    assert done[0] < min(fetch_ends), events
    c.close()


def test_batcher_groups_overlap(pkg, tmp_path, rng, monkeypatch):
    """Through the SearchBatcher: a second group forms and dispatches while
    the first group's fetch is in flight."""
    monkeypatch.setattr(pkg.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
    c, _ = make_coll(pkg, tmp_path, rng, n=512, dims=16)
    events, _ = _spy_fetch_and_dispatch(pkg, monkeypatch, 0.25)
    batcher = pkg.batcher.SearchBatcher(window_s=0.03, max_batch=4)
    q = rng.uniform(-1, 1, size=16)
    errs = []

    def one_query():
        try:
            batcher.search(c, Args(pkg, vector=q, k=3, precision="high"))
        except BaseException as exc:  # pragma: no cover
            errs.append(exc)

    wave1 = [threading.Thread(target=one_query) for _ in range(4)]
    wave2 = [threading.Thread(target=one_query) for _ in range(4)]
    for t in wave1:
        t.start()
    time.sleep(0.15)
    for t in wave2:
        t.start()
    for t in wave1 + wave2:
        t.join()
    assert not errs, errs
    dispatches = sorted(t for tag, t in events if tag == "dispatch")
    fetch_ends = sorted(t for tag, t in events if tag == "fetch_end")
    assert len(dispatches) >= 2, events
    assert dispatches[1] < fetch_ends[0], events
    c.close()


def test_batcher_grow_gap_close(pkg, tmp_path, rng):
    c, _ = make_coll(pkg, tmp_path, rng, n=50)
    batcher = pkg.batcher.SearchBatcher(window_s=30.0, grow_gap_s=0.05)
    queries = rng.uniform(-1, 1, size=(4, 16))
    results = [None] * 4

    def worker(i):
        results[i] = batcher.search(c, Args(pkg, vector=queries[i], k=3))

    t0 = time.perf_counter()
    assert not run_threads(4, worker)
    took = time.perf_counter() - t0
    assert all(r is not None for r in results)
    assert took < 10.0, took
    assert batcher.dispatches < 4
    c.close()


def test_rest_http11_keepalive_reuse(pkg, tmp_path, rng):
    import http.client

    srv = pkg.Server(tmp_path)
    c, vecs = make_coll(pkg, tmp_path, rng, n=40)
    srv.collections["ka"] = c
    httpd = pkg.rest.make_http_server(srv)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port)
        for i in range(3):
            conn.request(
                "POST", "/api/v1/collections/ka/search",
                body=json.dumps({"vector": vecs[i].tolist(), "k": 2}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.version == 11
            out = json.loads(resp.read())
            assert len(out["results"]) == 2
            assert out["results"][0]["id"] == i
        conn.close()
    finally:
        httpd.shutdown()
        c.close()


def test_dead_leader_group_is_retired(pkg, tmp_path, rng):
    c, vecs = make_coll(pkg, tmp_path, rng, n=64)
    batcher = pkg.batcher.SearchBatcher(window_s=0.005)
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    key = (c.batch_token, "knn", 3, "medium", "")
    zombie = pkg.batcher._Group()
    zombie.leader_thread = dead
    with batcher._lock:
        batcher._groups[key] = zombie
    args = Args(pkg, vector=vecs[0], k=3, precision="medium")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="leader thread died"):
        batcher.search(c, args)
    assert time.monotonic() - t0 < 5.0
    with batcher._lock:
        assert batcher._groups.get(key) is not zombie
    res = batcher.search(c, args)
    assert [r.id for r in res.results]
    c.close()


def test_batched_results_equal_between_packages(tmp_path, rng, monkeypatch):
    """One concurrent burst through each package's batcher on the same
    documents (device branches on): equal ids per query."""
    queries = rng.uniform(-1, 1, size=(12, 16))
    out = {}
    for name in ("jax", "torch"):
        p = Pkg(name)
        monkeypatch.setattr(p.coll_mod, "HOST_SCAN_MAX_ELEMS", 0)
        (tmp_path / name).mkdir()
        c, _ = make_coll(p, tmp_path / name, np.random.default_rng(3))
        batcher = p.batcher.SearchBatcher(window_s=0.05)
        got = [None] * len(queries)

        def worker(i):
            got[i] = [r.id for r in batcher.search(c, Args(
                p, vector=queries[i], k=6, precision="high")).results]

        assert not run_threads(len(queries), worker)
        assert batcher.dispatches < batcher.queries
        out[name] = got
        c.close()
    assert out["torch"] == out["jax"]

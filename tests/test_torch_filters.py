"""Query-string filters on the port (syzgydb_tpu_torch/query/, build_filter,
the native JSON projector and Collection's filter masks) against the JAX
package's.

The goldens of tests/test_query.py and the document and query tables of
tests/test_columnar_filter.py are loaded from those files by path and run
through both query packages: both must give the same filter results, the
same columnar masks and the same errors.  A grammar-driven differential
fuzz (the generator of tests/test_columnar_filter.py) holds the port's
columnar engine to the JAX package's and to the per-row engine.  Filtered
kNN, radius and list mode then run through both Collections on the same
documents; ids and percent_searched must match (distances as in
tests/test_torch_collection.py)."""

import importlib.util
import json
import logging
import os
import random

import numpy as np
import pytest

import syzgydb_tpu as jdb
import syzgydb_tpu_torch as tdb
from syzgydb_tpu import query as jquery
from syzgydb_tpu.core import collection as jcoll
from syzgydb_tpu.query import columnar as jcolumnar
from syzgydb_tpu_torch import native as tnative
from syzgydb_tpu_torch import query as tquery
from syzgydb_tpu_torch.core import collection as tcoll
from syzgydb_tpu_torch.query import columnar as tcolumnar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(ROOT, "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_golden_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLD = _load("test_query")
COLS = _load("test_columnar_filter")


class FakeColumns:
    """Duck-typed ColumnStore: metadata + valid + size + version."""

    def __init__(self, metas):
        self.size = len(metas)
        self.version = 1
        self.metadata = metas
        self.valid = np.ones(self.size, dtype=bool)


def _outcome(fn, data):
    try:
        return ("ok", fn(data))
    except Exception as exc:  # the error path is part of the semantics
        return ("error", type(exc).__name__)


# ---------------------------------------------------------------------------
# query language goldens (tests/test_query.py)
# ---------------------------------------------------------------------------

LEX = ["a == 1 AND b != 2 OR c >= 3", "x DOES NOT EXIST", "n == 0x1F",
       "n == 1.5e-3", "s == 'it\\'s' OR t == \"q\"", "items[*] == a[0]",
       "true false null NOT IN CONTAINS", "LENGTH(name) > :min"]


@pytest.mark.parametrize("text", LEX)
def test_lexer_tokens_match(text):
    def toks(mod):
        return [(t.type.value, t.literal)
                for t in mod.Lexer(text).tokens()[:-1]]

    assert toks(tquery) == toks(jquery)


@pytest.mark.parametrize("query,want", [
    ("age == 30", "==(age, 30)"),
    ("a == 1 OR b == 2 AND c == 3", "OR(==(a, 1), AND(==(b, 2), ==(c, 3)))"),
    ("items[0].name == 'x'", "==(.([](items, 0), name), 'x')"),
    ("status NOT IN ['a']", "NOT_IN(status, ['a'])"),
    ("field DOES NOT EXIST", "DOES_NOT_EXIST(field)"),
    ("price >= :min", ">=(price, :min)"),
    ("ANY(items[*], quantity > 100)", None),
])
def test_parser_ast_shapes_match(query, want):
    got = str(tquery.parse_query(query))
    assert got == str(jquery.parse_query(query))
    if want is not None:
        assert got == want


def test_parser_errors_match():
    for bad in ["== 3", "a IN 3", "a IN [", "(a == 1", "a.", "a == ", ""]:
        with pytest.raises(tquery.QueryError):
            tquery.parse_query(bad)
        with pytest.raises(jquery.QueryError):
            jquery.parse_query(bad)


@pytest.mark.parametrize("query,data,want", GOLD.CASES)
def test_filter_goldens_match(query, data, want):
    port = tquery.filter_function_from_query(query)
    ref = jquery.filter_function_from_query(query)
    assert port(data) is want
    assert _outcome(port, data) == _outcome(ref, data)


def test_filter_error_paths_match():
    cases = [("user.name == 'x'", b'{"user": {}}'),
             ("user.name == 'x'", b'{"user": 5}'),
             ("user.name == 'x'", b"not json"),
             ("age", b'{"age": 30}'),
             ("age > 'abc'", b'{"age": 30}'),
             ("age == 'abc'", b'{"age": 30}'),
             ("flag == 1", b'{"flag": true}')]
    for query, data in cases:
        port = _outcome(tquery.filter_function_from_query(query), data)
        assert port == _outcome(jquery.filter_function_from_query(query),
                                data), query
    filt = tdb.build_filter("user.name == 'x'")
    assert filt(1, b'{"user": {"name": "x"}}') is True
    assert filt(2, b'{"user": {}}') is False  # eval error -> rejected
    assert filt(3, b"bad json") is False


# ---------------------------------------------------------------------------
# columnar engine (tests/test_columnar_filter.py)
# ---------------------------------------------------------------------------

def _engines(engine_kind, monkeypatch):
    if engine_kind == "python":
        for mod in (tcolumnar, jcolumnar):
            monkeypatch.setattr(mod.ColumnarFilterEngine, "_project_native",
                                lambda self, f, c: False)
    elif tnative.get_jsonproj() is None:
        pytest.skip("native jsonproj unavailable (no g++)")
    return tcolumnar.ColumnarFilterEngine(), jcolumnar.ColumnarFilterEngine()


@pytest.mark.parametrize("engine_kind", ["native", "python"])
def test_columnar_masks_match(engine_kind, monkeypatch):
    port, ref = _engines(engine_kind, monkeypatch)
    cols = FakeColumns(COLS.METAS)
    for query in COLS.QUERIES:
        got = port.evaluate(query, cols)
        assert got is not None, query
        np.testing.assert_array_equal(got, ref.evaluate(query, cols),
                                      err_msg=query)
        flt = tdb.build_filter(query)
        np.testing.assert_array_equal(
            got, [flt(i, m) for i, m in enumerate(COLS.METAS)],
            err_msg=query)


def test_columnar_fallback_shapes_match():
    cols = FakeColumns(COLS.METAS)
    for query in ["1 == 1", "name MATCHES pattern", "tags == [age]",
                  "ANY(items, ANY(tags, x == 1))", "user == 'scalar'",
                  "items[zero].price == 1"]:
        assert tcolumnar.ColumnarFilterEngine().evaluate(query, cols) is None
        assert jcolumnar.ColumnarFilterEngine().evaluate(query, cols) is None
    nondict = FakeColumns(COLS.METAS + [b"[1, 2, 3]"])
    assert tcolumnar.ColumnarFilterEngine().evaluate("age == 30",
                                                     nondict) is None


def test_native_projection_matches_jax():
    """The port's jp_extract (root native/jsonproj.cpp built into the
    port's own native/) returns the JAX package's arrays on tricky docs."""
    from syzgydb_tpu.native import jp_extract as jax_jp
    if tnative.get_jsonproj() is None:
        pytest.skip("native jsonproj unavailable (no g++)")
    docs = COLS.METAS + [
        b'{"a": 1, "b": bogus}', b"{'a': 1}", b'{"age": 01}',
        b'{"age": -Infinity}', b'{"name": "x\\qy"}', b'{"name": "a\\u00e9b"}',
        b'{"age": NaN}', b'{"dup": 1, "dup": "two"}', b'  {"ws": 1}  ',
        b'{"age": 2, "junk": "\xff\xfe"}', None, b""]
    fields = ["age", "name", "dup", "ws", "a"]
    got = tnative.jp_extract(docs, fields)
    want = jax_jp(docs, fields)
    assert os.path.dirname(tnative._JP_PATH).endswith(
        os.path.join("syzgydb_tpu_torch", "native"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _fuzz_generator(rnd):
    """tests/test_columnar_filter.py's grammar-driven generator: random
    documents and random expressions over them."""
    scalars = [0, 1, 30, -2, 17.5, 0.5, "red", "blue", "", "zoe",
               True, False, None]
    fields = ["age", "name", "score", "tags", "items", "user", "idx",
              "flags", "nil"]

    def rand_doc():
        d = {}
        for f in fields:
            r = rnd.random()
            if r < 0.25:
                continue
            elif r < 0.55:
                d[f] = rnd.choice(scalars)
            elif r < 0.7:
                d[f] = [rnd.choice(scalars)
                        for _ in range(rnd.randint(0, 3))]
            elif r < 0.85:
                d[f] = {"name": rnd.choice(scalars),
                        "age": rnd.choice(scalars)}
            else:
                d[f] = [{"price": rnd.choice(scalars),
                         "name": rnd.choice(scalars)}
                        for _ in range(rnd.randint(0, 3))]
        return d

    def lit():
        v = rnd.choice(scalars)
        if isinstance(v, bool):
            return "true" if v else "false"
        if v is None:
            return "null"
        if isinstance(v, str):
            return "'%s'" % v
        return repr(v)

    def operand(inside_any):
        r = rnd.random()
        base = rnd.choice(["price", "name", "x"]) if inside_any \
            else rnd.choice(fields)
        if not inside_any:
            if r < 0.15:
                return base + "." + rnd.choice(["name", "age", "length"])
            if r < 0.3:
                return "%s[%d]" % (base, rnd.randint(-1, 4))
            if r < 0.4:
                return "%s[%s]" % (base, rnd.choice(["idx", "age", "name"]))
            if r < 0.5:
                return "LENGTH(%s)" % base
        elif r < 0.2:
            return "LENGTH(%s)" % base
        return base

    def leaf(inside_any):
        r2 = rnd.random()
        if r2 < 0.5:
            op = rnd.choice(["==", "!=", ">", ">=", "<", "<="])
            a = operand(inside_any)
            r = rnd.random()
            b = lit() if r < 0.5 else operand(inside_any)
            if r >= 0.8:
                a, b = lit(), a
            return "%s %s %s" % (a, op, b)
        if r2 < 0.65:
            return "%s %s %s" % (
                operand(inside_any),
                rnd.choice(["CONTAINS", "STARTS_WITH", "ENDS_WITH",
                            "MATCHES"]),
                rnd.choice(["'red'", "'o'", "'^[ab]'", "'e$'", "''"]))
        if r2 < 0.75:
            vals = ", ".join(lit() for _ in range(rnd.randint(1, 3)))
            return "%s %sIN [%s]" % (
                operand(inside_any),
                "NOT " if rnd.random() < 0.5 else "", vals)
        if r2 < 0.85:
            return "%s %s" % (operand(inside_any),
                              rnd.choice(["EXISTS", "DOES NOT EXIST"]))
        if not inside_any and r2 < 0.95:
            arr = "[%s]" % ", ".join(lit()
                                     for _ in range(rnd.randint(0, 3)))
            return "%s %s %s" % (
                rnd.choice(["tags", "flags", "nested", "items"]),
                rnd.choice(["==", "!="]), arr)
        return "%s == %s" % (operand(inside_any), lit())

    def expr(depth=0, inside_any=False):
        r = rnd.random()
        if depth < 2 and r < 0.25:
            return "(%s) %s (%s)" % (
                expr(depth + 1, inside_any), rnd.choice(["AND", "OR"]),
                expr(depth + 1, inside_any))
        if depth < 2 and r < 0.32:
            return "NOT (%s)" % expr(depth + 1, inside_any)
        if not inside_any and depth < 2 and r < 0.42:
            return "%s(%s%s, %s)" % (
                rnd.choice(["ANY", "ALL"]),
                rnd.choice(["items", "tags", "flags", "nested"]),
                "[*]" if rnd.random() < 0.5 else "",
                expr(depth + 1, True))
        return leaf(inside_any)

    return rand_doc, expr


@pytest.mark.parametrize("seed", [7, 123])
def test_random_query_differential_fuzz(seed):
    rand_doc, expr = _fuzz_generator(random.Random(seed))
    for name in ("syzgydb", "syzgydb_tpu"):
        logging.getLogger(name).setLevel(logging.CRITICAL)
    try:
        vectorized = 0
        for _ in range(300):
            docs = [rand_doc() for _ in range(25)]
            metas = [json.dumps(d).encode() for d in docs] + [b"not json"]
            q = expr()
            try:
                ref_flt = jdb.build_filter(q)
            except Exception:
                with pytest.raises(Exception):
                    tdb.build_filter(q)
                continue
            flt = tdb.build_filter(q)
            per_row = np.array([bool(flt(i, m)) for i, m in enumerate(metas)])
            np.testing.assert_array_equal(
                per_row, [bool(ref_flt(i, m)) for i, m in enumerate(metas)],
                err_msg=q)
            got = tcolumnar.ColumnarFilterEngine().evaluate(
                q, FakeColumns(metas))
            want = jcolumnar.ColumnarFilterEngine().evaluate(
                q, FakeColumns(metas))
            assert (got is None) == (want is None), q
            if got is None:
                continue
            vectorized += 1
            np.testing.assert_array_equal(np.asarray(got, bool),
                                          np.asarray(want, bool), err_msg=q)
            np.testing.assert_array_equal(np.asarray(got, bool), per_row,
                                          err_msg=q)
        assert vectorized > 40
    finally:
        for name in ("syzgydb", "syzgydb_tpu"):
            logging.getLogger(name).setLevel(logging.NOTSET)


# ---------------------------------------------------------------------------
# filtered searches through both Collections
# ---------------------------------------------------------------------------

N, DIMS = 3000, 32


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """Both packages' collections on the same documents; the host scan is
    off so every precision reaches the device branch (the JAX package's
    Pallas scan in interpret mode, the port's plain kernels)."""
    from syzgydb_tpu.ops import pallas_scan as jscan
    monkeypatch.setattr(jscan, "supported", lambda: True)
    monkeypatch.setattr(jdb.Collection, "_kernel_interpret", True)
    monkeypatch.setattr(jcoll, "HOST_SCAN_MAX_ELEMS", 0)
    monkeypatch.setattr(tcoll, "HOST_SCAN_MAX_ELEMS", 0)
    rng = np.random.default_rng(31)
    vecs = rng.uniform(-1, 1, size=(N, DIMS))
    metas = [json.dumps({"i": i, "cat": i % 5, "name": f"doc{i}"}).encode()
             for i in range(N)]
    out = []
    for pkg, name, kw in ((jdb, "jax.dat", {}),
                          (tdb, "port.dat", {"device": "cpu"})):
        c = pkg.Collection(pkg.CollectionOptions(
            name=str(tmp_path / name), distance_method=pkg.COSINE,
            dimension_count=DIMS, quantization=8, index_seed=3,
            search_budget=512), **kw)
        c.add_documents(list(range(N)), vecs, metas)
        out.append(c)
    yield out[0], out[1], vecs
    for c in out:
        c.close()


def _surr(d):
    return (1.0 - np.cos(np.pi * np.asarray(d, dtype=np.float64))) / 2


def _same(a, b, exact: bool):
    assert {r.id for r in a.results} == {r.id for r in b.results}
    assert a.percent_searched == b.percent_searched
    da = sorted(r.distance for r in a.results)
    dbb = sorted(r.distance for r in b.results)
    if exact:
        assert da == dbb
    else:
        np.testing.assert_allclose(_surr(dbb), _surr(da), rtol=1e-5,
                                   atol=2e-5)


FILTERS = ["i < 1500", "cat == 2 AND name ENDS_WITH '7'", "i >= 2990",
           "name MATCHES '^doc1[0-9]$' OR i == 2999"]


@pytest.mark.parametrize("fq", FILTERS)
def test_filtered_knn_radius_and_list_match_jax(pair, fq):
    jc, tc, vecs = pair
    flt = tdb.build_filter(fq)
    rng = np.random.default_rng(5)
    queries = vecs[rng.integers(0, N, 9)] + 0.1 * rng.standard_normal(
        (9, DIMS))
    for precision in ("high", "exact"):
        jb = jc.search_many([jdb.SearchArgs(vector=q, k=10, filter_query=fq,
                                            precision=precision)
                             for q in queries])
        tb = tc.search_many([tdb.SearchArgs(vector=q, k=10, filter_query=fq,
                                            precision=precision)
                             for q in queries])
        for a, b in zip(jb, tb):
            assert all(flt(r.id, r.metadata) for r in b.results)
            _same(a, b, precision == "exact")
        a = jc.search(jdb.SearchArgs(vector=queries[0], radius=0.4,
                                     filter_query=fq, precision=precision))
        b = tc.search(tdb.SearchArgs(vector=queries[0], radius=0.4,
                                     filter_query=fq, precision=precision))
        assert all(flt(r.id, r.metadata) and r.distance <= 0.4
                   for r in b.results)
        _same(a, b, precision == "exact")
    # medium: candidates inside the filter; both index budgets cover the
    # filtered set or the results are held to the filter only
    for q in queries[:3]:
        b = tc.search(tdb.SearchArgs(vector=q, k=10, filter_query=fq))
        assert all(flt(r.id, r.metadata) for r in b.results)
    # list mode with offset and limit
    for offset, limit in ((0, 0), (3, 5)):
        a = jc.search(jdb.SearchArgs(filter_query=fq, offset=offset,
                                     limit=limit))
        b = tc.search(tdb.SearchArgs(filter_query=fq, offset=offset,
                                     limit=limit))
        assert [r.id for r in b.results] == [r.id for r in a.results]
        assert [r.metadata for r in b.results] == \
            [r.metadata for r in a.results]
        assert b.percent_searched == a.percent_searched
        assert all(flt(r.id, r.metadata) for r in b.results)


def test_filter_mask_cache_and_tiers(pair):
    """The mask is cached per (query, mutation generation); a shape the
    columnar tier cannot take runs the compiled closure per row and is
    cached too; a mutation re-evaluates."""
    _, tc, vecs = pair
    q = "cat == 1"
    r1 = tc.search(tdb.SearchArgs(vector=vecs[0], k=50, filter_query=q,
                                  precision="exact"))
    assert all(r.id % 5 == 1 for r in r1.results)
    ver = tc._filter_cache[q][0]
    mask = tc._filter_cache[q][1]
    assert int(tc._filter_cache[q][2]) == N // 5
    tc.search(tdb.SearchArgs(vector=vecs[1], k=5, filter_query=q,
                             precision="high"))
    assert tc._filter_cache[q][1] is mask  # cache hit
    fallback = "1 == 1 AND cat == 1"  # literal-vs-literal: per row
    assert tc._columnar_filter.evaluate(fallback, tc.columns) is None
    r2 = tc.search(tdb.SearchArgs(vector=vecs[0], k=50,
                                  filter_query=fallback, precision="exact"))
    assert {r.id for r in r2.results} == {r.id for r in r1.results}
    assert fallback in tc._filter_cache
    tc.add_document(N + 1, vecs[0], b'{"i": -1, "cat": 1, "name": "x"}')
    r3 = tc.search(tdb.SearchArgs(vector=vecs[0], k=50, filter_query=q,
                                  precision="exact"))
    assert tc._filter_cache[q][0] != ver
    assert r3.results[0].id == N + 1
    for i in range(20):
        tc.search(tdb.SearchArgs(vector=vecs[0], k=1, filter_query=f"i == {i}",
                                 precision="high"))
    assert len(tc._filter_cache) == tc._FILTER_CACHE_SIZE

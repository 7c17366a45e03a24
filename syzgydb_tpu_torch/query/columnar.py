"""Vectorized metadata filtering over columnar field projections.

The reference re-unmarshals every document's JSON per candidate per search
(collection.go:583-596); our per-row fallback (build_filter) already does it
once per row per search, but an uncached 1M-row filtered search still costs
a ~2s Python loop.  This module replaces that loop for the common predicate
shapes with numpy mask algebra over per-field columnar projections:

  * extraction: ONE parse pass per (referenced fields, mutation generation)
    pulls the top-level values of every referenced field into typed arrays
    (float64 numbers, object strings, presence/type masks), cached until the
    collection mutates;
  * evaluation: ==, !=, <, <=, >, >=, IN, NOT IN, CONTAINS, STARTS_WITH,
    ENDS_WITH, MATCHES, EXISTS(f), DOES_NOT_EXIST(f), AND/OR/NOT over those
    become vectorized mask ops — microseconds per million rows instead of
    seconds;
  * path expressions: nested dotted paths (`a.b.c`), literal array indexing
    (`tags[0]`), `.length`, `LENGTH(x)`, and `:param` placeholders project
    into derived "path columns".  `:param` derives for free from the root
    field's top-level column (the reference resolves parameters against the
    document map itself — compiler.py:106-112); other non-trivial paths pay
    ONE python parse+walk pass per (new path set, mutation generation),
    cached thereafter — the cost of a single fallback query amortized over
    every query that touches the path.  Field-vs-field predicates
    (`price > cost`, `name == :expected`) vectorize as column-vs-column
    masks.

  * quantifiers and arrays: ANY/ALL conditions evaluate over a
    (row, position)-expanded element space — one python pass per (array
    path, mutation generation) flattens the array into CSR element columns
    (bounded by _ARR_CAP elements; beyond that the query falls back), the
    condition vectorizes over the flattened elements with the document row
    as a segment id, and the quantifier reduces per-segment with bincount.
    Whole-array equality (`tags == ['red', 'blue']`) compares the CSR
    layout against the literal positionally with python's list-equality
    semantics (the per-row engine's _deep_equal defers to `a == b` for
    lists, so bool==number holds INSIDE arrays).  Dynamic array indices
    (`items[cursor]`) gather the CSR at each row's own index value.

Error-semantics parity with query/compiler.py (which mirrors the Go
compiler's eager evaluation): every node's (value, error) pair is tracked as
two masks; an error anywhere in the tree rejects the row, exactly like the
exception path in build_filter.  Path extraction records per-row errors in
FieldColumn.err (e.g. `.` on a missing nested key raises, while an
out-of-bounds `[i]` yields nil — compiler.py:244-264).  Queries or field
values outside the supported shapes (array-valued terminal values in
scalar predicates, nested quantifiers, non-path dynamic indices) return
None and the caller falls back to the per-row engine — semantics first,
speed second.
"""

from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np

from .parser import (AllNode, AnyNode, ArrayNode, ArrayStarNode,
                     ExpressionNode, FunctionNode, IdentifierNode, Node,
                     ParameterNode, ValueNode, parse_query)

_COMPARE_OPS = (">", ">=", "<", "<=")
_EQ_OPS = ("==", "!=")
_STR_OPS = ("CONTAINS", "STARTS_WITH", "ENDS_WITH", "MATCHES")


class FieldColumn:
    """Typed columnar projection of one top-level metadata key or one
    derived path expression (a.b.c, tags[0], LENGTH(x), :param)."""

    __slots__ = ("present", "is_num", "is_str", "is_bool", "is_none",
                 "nums", "strs", "scalar", "err")

    def __init__(self, n: int):
        self.present = np.zeros(n, bool)
        self.is_num = np.zeros(n, bool)   # non-bool JSON numbers
        self.is_str = np.zeros(n, bool)
        self.is_bool = np.zeros(n, bool)
        self.is_none = np.zeros(n, bool)  # explicit JSON null
        self.nums = np.zeros(n, np.float64)  # numbers and bools (0/1)
        self.strs = np.empty(n, object)
        self.scalar = True  # False once any row holds an array/object
        # rows whose EXTRACTION raised EvalError (path columns only: `.` on
        # a missing key / non-container, `:param` absent, LENGTH of a
        # non-sized value) — any predicate touching the column rejects them
        self.err = np.zeros(n, bool)

    def set(self, row: int, value) -> None:
        self.present[row] = True
        if isinstance(value, bool):
            self.is_bool[row] = True
            self.nums[row] = 1.0 if value else 0.0
        elif isinstance(value, (int, float)):
            self.is_num[row] = True
            self.nums[row] = float(value)
        elif isinstance(value, str):
            self.is_str[row] = True
            self.strs[row] = value
        elif value is None:
            self.is_none[row] = True
        else:
            self.scalar = False


# Bound on the (row, position)-expanded element space: one flattened
# element costs ~25 bytes of CSR state plus a reference to the parsed
# fragment; past this the memory and the per-element python projection
# passes stop being worth it vs one per-row fallback query.
_ARR_CAP = 16_000_000
# out-of-core metadata: rows per bounded native-projection chunk
_OOC_PROJECT_CHUNK = 65536

# element kind codes in ArrayColumn.kinds
_K_NUM, _K_STR, _K_BOOL, _K_NULL, _K_COMPLEX = 1, 2, 3, 4, 5


class ArrayColumn:
    """CSR projection of one array-valued path: row r's elements live at
    flat positions starts[r]:starts[r+1].  kinds/nums/strs mirror
    FieldColumn typing per element; elems keeps the parsed python values
    (dict elements feed the quantifier's element-path projections)."""

    __slots__ = ("is_list", "err", "starts", "kinds", "nums", "strs",
                 "elems", "rowidx")

    def __init__(self, n: int):
        self.is_list = np.zeros(n, bool)
        self.err = np.zeros(n, bool)      # the path WALK raised
        self.starts = np.zeros(n + 1, np.int64)
        self.kinds = np.zeros(0, np.int8)
        self.nums = np.zeros(0, np.float64)
        self.strs = np.empty(0, object)
        self.elems: list = []
        self.rowidx = np.zeros(0, np.int64)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)


def _elem_eq_mask(kinds, nums, strs, lit) -> np.ndarray:
    """Positional python `==` of elements vs a scalar literal (the per-row
    engine compares whole arrays with python list equality, under which
    True == 1.0 — unlike top-level _deep_equal)."""
    if isinstance(lit, (bool, int, float)):
        with np.errstate(all="ignore"):
            return ((kinds == _K_NUM) | (kinds == _K_BOOL)) \
                & (nums == float(lit))
    if isinstance(lit, str):
        with np.errstate(all="ignore"):
            return (kinds == _K_STR) & np.asarray(strs == lit, dtype=bool)
    if lit is None:
        return kinds == _K_NULL
    return np.zeros(len(kinds), bool)


def _arr_eq_mask(arr: ArrayColumn, lit: list) -> tuple:
    """Vectorized `path == [literal, ...]`: row matches iff its value is a
    list of equal length whose elements positionally python-equal the
    literal's.  Non-list rows (including nil from a missing key) compare
    False without error (_deep_equal type mismatch); only a failed path
    walk errors."""
    n = len(arr.is_list)
    cand = arr.is_list & (arr.lengths == len(lit))
    val = np.zeros(n, bool)
    if not lit:
        val = cand.copy()  # [] == [] is True
        return val, arr.err.copy()
    rows = np.flatnonzero(cand)
    if len(rows):
        ok = np.ones(len(rows), bool)
        base = arr.starts[rows]
        for j, litv in enumerate(lit):
            idx = base + j
            ok &= _elem_eq_mask(arr.kinds[idx], arr.nums[idx],
                                arr.strs[idx], litv)
        val[rows] = ok
    return val, arr.err.copy()


def _is_literal_array(node) -> bool:
    """ArrayNode whose elements are all scalar literals (the only array
    shape the vectorized equality supports)."""
    return isinstance(node, ArrayNode) and all(
        isinstance(e, ValueNode) and not isinstance(e.value, (list, dict))
        for e in node.elements)


def _contains_quantifier(node) -> bool:
    if isinstance(node, (AnyNode, AllNode)):
        return True
    if isinstance(node, ExpressionNode):
        return any(_contains_quantifier(s) for s in (node.left, node.right)
                   if s is not None)
    if isinstance(node, FunctionNode):
        return any(_contains_quantifier(a) for a in node.arguments)
    if isinstance(node, ArrayNode):
        return any(_contains_quantifier(e) for e in node.elements)
    return False


def _quant_array_path(node) -> Optional[tuple]:
    """The quantifier's array operand as a path tuple (unwrapping the
    optional `[*]` marker), or None."""
    arr = node.array
    if isinstance(arr, ArrayStarNode):
        arr = arr.array
    return _path_of(arr)


def _collect_array_paths(node, out: list) -> None:
    """Array paths the query will project (quantifier operands + whole-
    array-equality subjects), so evaluate() can batch them into ONE doc
    parse pass instead of one pass per path."""
    if isinstance(node, (AnyNode, AllNode)):
        p = _quant_array_path(node)
        if p is not None:
            out.append(p)
        return  # condition runs in element space; no doc-level arrays
    if isinstance(node, ExpressionNode):
        if node.operator in _EQ_OPS:
            sides = (node.left, node.right)
            if any(_is_literal_array(s) for s in sides):
                other = sides[1] if _is_literal_array(sides[0]) else sides[0]
                p = None if isinstance(other, ArrayNode) else _path_of(other)
                if p is not None:
                    out.append(p)
                return
        if node.operator in _EQ_OPS + _COMPARE_OPS:
            for side in (node.left, node.right):
                dyn = _dyn_index_of(side)
                if dyn is not None:
                    out.append(dyn[0])
        for side in (node.left, node.right):
            if side is not None:
                _collect_array_paths(side, out)
        return
    if isinstance(node, FunctionNode):
        for a in node.arguments:
            _collect_array_paths(a, out)


def _path_of(node) -> Optional[tuple]:
    """Canonical step tuple for a "path expression" — an identifier,
    `:param`, a dotted/indexed chain, or LENGTH(path) — else None.

    Steps: ("id", name) root, ("param", name) root, ("key", k) for `.k`,
    ("idx", i) for a literal `[i]`, ("len",) for LENGTH(...)."""
    if isinstance(node, IdentifierNode):
        return (("id", node.name),)
    if isinstance(node, ParameterNode):
        return (("param", node.name),)
    if isinstance(node, FunctionNode):
        if node.name == "LENGTH" and len(node.arguments) == 1:
            base = _path_of(node.arguments[0])
            return None if base is None else base + (("len",),)
        return None
    if isinstance(node, ExpressionNode):
        if node.operator == ".":
            base = _path_of(node.left)
            if base is None or not isinstance(node.right, IdentifierNode):
                return None
            return base + (("key", node.right.name),)
        if node.operator == "[]":
            base = _path_of(node.left)
            idx = node.right
            if base is None or not isinstance(idx, ValueNode) \
                    or isinstance(idx.value, bool) \
                    or not isinstance(idx.value, (int, float)):
                return None
            # int(round(float)) replicates the per-row engine
            # (compiler.py:261); negative/OOB indices evaluate to nil there
            return base + (("idx", int(round(float(idx.value)))),)
        return None
    return None


def _dyn_index_of(node) -> Optional[tuple]:
    """(array_path, index_path) for a DYNAMIC array index `arr[expr]`
    where arr is a path and expr is a path/param (literal indices are
    plain paths via _path_of) — else None."""
    if not (isinstance(node, ExpressionNode) and node.operator == "[]"):
        return None
    base = _path_of(node.left)
    if base is None or isinstance(node.right, ValueNode):
        return None
    idx = _path_of(node.right)
    if idx is None:
        return None
    return base, idx


def _dyn_index_column(arr: ArrayColumn, idx: FieldColumn) -> FieldColumn:
    """Vectorized `arr[i]` with a per-row index: per-row engine semantics
    (compiler.py:255-264) — non-list value or non-number index errors,
    out-of-bounds yields nil, otherwise the element projects like any
    scalar terminal (complex elements flip .scalar, bailing the query)."""
    n = len(arr.is_list)
    col = FieldColumn(n)
    # is_num already excludes bools (bool indices error per _is_number)
    col.err = arr.err | ~arr.is_list | idx.err | ~idx.is_num
    with np.errstate(invalid="ignore"):
        i = np.round(idx.nums).astype(np.int64)
    lens = arr.lengths
    ok = ~col.err & (i >= 0) & (i < lens)
    pos = np.clip(arr.starts[:-1] + i, 0, max(len(arr.kinds) - 1, 0))
    rows = np.flatnonzero(ok)
    if len(rows):
        p = pos[rows]
        k = arr.kinds[p]
        col.present[rows] = True
        col.is_num[rows] = k == _K_NUM
        col.is_bool[rows] = k == _K_BOOL
        col.is_str[rows] = k == _K_STR
        col.is_none[rows] = k == _K_NULL
        col.nums[rows] = arr.nums[p]
        col.strs[rows] = np.where(k == _K_STR, arr.strs[p], None)
        # present must mirror "value is not nil": explicit-null elements
        # DO exist (k == _K_NULL keeps present), but complex elements
        # poison vectorization like any non-scalar terminal
        if (k == _K_COMPLEX).any():
            col.scalar = False
    # rows with ok False and no err: out-of-bounds -> nil (absent)
    return col


def _is_trivial(path: tuple) -> bool:
    """A bare top-level identifier (projects via the native extractor)."""
    return len(path) == 1 and path[0][0] == "id"


def _col_key(path: tuple):
    """Cache key in the engine's column dict: plain field name for trivial
    identifiers (shared with the native projection), the step tuple
    otherwise — the types can't collide."""
    return path[0][1] if _is_trivial(path) else path


def referenced_paths(node) -> Optional[set]:
    """Path expressions the query touches (as step tuples), or None if the
    query uses any construct the vectorizer does not support."""
    if isinstance(node, ExpressionNode):
        op = node.operator
        if op in ("AND", "OR"):
            lf = referenced_paths(node.left)
            rf = referenced_paths(node.right)
            return None if lf is None or rf is None else lf | rf
        if op == "NOT":
            return referenced_paths(node.right)
        if op in _EQ_OPS:
            # whole-array equality: path == [scalar literals] projects the
            # path as an ArrayColumn lazily inside _vectorize — no
            # top-level field projection needed, but the shape is
            # supported, so signal "vectorizable, no regular paths"
            sides = (node.left, node.right)
            if any(_is_literal_array(s) for s in sides):
                arr_side = 0 if _is_literal_array(node.left) else 1
                other = sides[1 - arr_side]
                if isinstance(other, ValueNode) or \
                        isinstance(other, ArrayNode):
                    return None  # literal-vs-literal / array-vs-array
                return set() if _path_of(other) is not None else None
        if op in _COMPARE_OPS + _EQ_OPS:
            out = set()
            for side in (node.left, node.right):
                if isinstance(side, ValueNode):
                    continue
                p = _path_of(side)
                if p is None:
                    dyn = _dyn_index_of(side)
                    if dyn is None:
                        return None
                    # dynamic `arr[i]`: the INDEX path projects normally;
                    # the array CSR projects lazily (_dyn_col)
                    out.add(dyn[1])
                    continue
                out.add(p)
            return out or None  # literal-vs-literal: fall back
        if op in _STR_OPS:
            # needle/pattern must be a literal string (a per-row regex
            # compile would defeat the point); subject must be a path
            p = _path_of(node.left)
            if p is None or not isinstance(node.right, ValueNode):
                return None
            return {p}
        if op in ("IN", "NOT_IN"):
            p = _path_of(node.left)
            if p is None or not isinstance(node.right, ArrayNode) or \
                    not all(isinstance(e, ValueNode)
                            for e in node.right.elements):
                return None
            return {p}
        return None
    if isinstance(node, (AnyNode, AllNode)):
        # quantifier: the array path and the condition's element-level
        # paths project lazily in _vectorize; nested quantifiers would
        # need elements-of-elements expansion — fall back
        if _quant_array_path(node) is None or \
                _contains_quantifier(node.condition):
            return None
        return set() if referenced_paths(node.condition) is not None \
            else None
    if isinstance(node, FunctionNode):
        if node.name == "EXISTS" and len(node.arguments) == 1:
            p = _path_of(node.arguments[0])
            return None if p is None else {p}
        if node.name == "DOES_NOT_EXIST" and len(node.arguments) == 1 \
                and isinstance(node.arguments[0], IdentifierNode):
            return {(("id", node.arguments[0].name),)}
        return None
    return None


def _operand(node, ctx):
    """("lit", value) | ("col", FieldColumn) | (None, None)."""
    if isinstance(node, ValueNode):
        return "lit", node.value
    p = _path_of(node)
    if p is not None:
        return "col", ctx.cols[_col_key(p)]
    dyn = _dyn_index_of(node)
    if dyn is not None and ctx.engine is not None:
        col = ctx.engine._dyn_col(dyn, ctx)
        if col is not None:
            return "col", col
    return None, None


def _eq_mask(col: FieldColumn, lit) -> np.ndarray:
    """Deep-equality mask (never errors): field == literal.

    A missing top-level key evaluates to None (compiler.py ident closure),
    so `f == null` is also true for absent keys."""
    if isinstance(lit, bool):
        return col.is_bool & (col.nums == (1.0 if lit else 0.0))
    if isinstance(lit, (int, float)):
        return col.is_num & (col.nums == float(lit))
    if isinstance(lit, str):
        with np.errstate(all="ignore"):
            eq = col.strs == lit  # object array: elementwise
        return col.is_str & np.asarray(eq, dtype=bool)
    if lit is None:
        return col.is_none | ~col.present
    return np.zeros(len(col.present), bool)  # non-scalar literal: never equal


def _null_mask(col: FieldColumn) -> np.ndarray:
    """Rows whose value is Go-nil: explicit null, a missing top-level key
    (ident closure returns None), or an OOB index (compiler.py:262-263).
    Extraction-error rows are excluded — they reject regardless."""
    return col.is_none | (~col.present & ~col.err)


def _eq_cols(a: FieldColumn, b: FieldColumn) -> tuple:
    """Vectorized _deep_equal(a, b) per row (compiler.py:48-57): same-typed
    scalars compare by value, bool never equals number, nil == nil."""
    with np.errstate(all="ignore"):
        streq = np.asarray(a.strs == b.strs, dtype=bool)
    val = (a.is_num & b.is_num & (a.nums == b.nums)) \
        | (a.is_bool & b.is_bool & (a.nums == b.nums)) \
        | (a.is_str & b.is_str & streq) \
        | (_null_mask(a) & _null_mask(b))
    return val, a.err | b.err


def _cmp_cols(op: str, a: FieldColumn, b: FieldColumn) -> tuple:
    """Vectorized _compare(a, b): num-num or str-str, else per-row error."""
    ok_num = a.is_num & b.is_num
    ok_str = a.is_str & b.is_str
    cmp = {">": np.greater, ">=": np.greater_equal,
           "<": np.less, "<=": np.less_equal}[op]
    val = ok_num & cmp(a.nums, b.nums)
    if ok_str.any():
        sa = np.where(a.is_str, a.strs, "")
        sb = np.where(b.is_str, b.strs, "")
        with np.errstate(all="ignore"):
            val = val | (ok_str & np.asarray(cmp(sa, sb), dtype=bool))
    return val, ~(ok_num | ok_str) | a.err | b.err


class _Ctx:
    """Evaluation context for _vectorize: the projected columns plus (at
    document level) the engine + column store for lazy array projections.
    Element-level contexts (inside a quantifier) carry engine=None — shapes
    that would need a second expansion level fall back."""

    __slots__ = ("cols", "engine", "columns")

    def __init__(self, cols: dict, engine=None, columns=None):
        self.cols = cols
        self.engine = engine
        self.columns = columns


def _vectorize(node, ctx: _Ctx) -> Optional[tuple]:
    """-> (value_mask, error_mask) or None if unsupported."""
    cols = ctx.cols
    if isinstance(node, (AnyNode, AllNode)):
        if ctx.engine is None:
            return None
        return ctx.engine._vectorize_quantifier(node, ctx.columns)
    if isinstance(node, ExpressionNode):
        op = node.operator
        if op in ("AND", "OR", "NOT"):
            rv = _vectorize(node.right, ctx)
            if rv is None:
                return None
            if op == "NOT":
                return ~rv[0], rv[1]
            lv = _vectorize(node.left, ctx)
            if lv is None:
                return None
            # run() evaluates BOTH sides before the op, so an eval error on
            # either side rejects the row even under OR's type-check
            # short-circuit (compiler.py:79-83, 213-219)
            err = lv[1] | rv[1]
            val = (lv[0] & rv[0]) if op == "AND" else (lv[0] | rv[0])
            return val, err

        if op in _EQ_OPS:
            sides = (node.left, node.right)
            if any(isinstance(s, ArrayNode) for s in sides):
                # whole-array equality vs a literal array of scalars
                arrnode = sides[0] if isinstance(sides[0], ArrayNode) \
                    else sides[1]
                other = sides[1] if arrnode is sides[0] else sides[0]
                if ctx.engine is None or not _is_literal_array(arrnode):
                    return None
                p = _path_of(other)
                if p is None:
                    return None
                arr = ctx.engine._project_array(p, ctx.columns)
                if arr is None:
                    return None
                val, err = _arr_eq_mask(
                    arr, [e.value for e in arrnode.elements])
                if op == "!=":
                    val = ~val
                return val, err
            lk, lval = _operand(node.left, ctx)
            rk, rval = _operand(node.right, ctx)
            if lk is None or rk is None:
                return None
            if lk == "col" and rk == "col":
                val, err = _eq_cols(lval, rval)
            else:  # referenced_paths guarantees at least one column side
                col, lit = (lval, rval) if lk == "col" else (rval, lval)
                val, err = _eq_mask(col, lit), col.err
            if op == "!=":
                val = ~val
            return val, err

        if op in _COMPARE_OPS:
            lk, lval = _operand(node.left, ctx)
            rk, rval = _operand(node.right, ctx)
            if lk is None or rk is None:
                return None
            if lk == "col" and rk == "col":
                return _cmp_cols(op, lval, rval)
            if lk == "lit":  # literal OP field  ->  field FLIP(OP) literal
                op = {">": "<", "<": ">", ">=": "<=", "<=": ">="}[op]
                col, lit = rval, lval
            else:
                col, lit = lval, rval
            if isinstance(lit, (int, float)) and not isinstance(lit, bool):
                ok = col.is_num
                a, b = col.nums, float(lit)
            elif isinstance(lit, str):
                ok = col.is_str
                sa = np.where(col.is_str, col.strs, "")
                with np.errstate(all="ignore"):
                    a, b = sa, lit
            else:
                # bool/null literals never compare: every row errors
                n = len(col.present)
                return np.zeros(n, bool), np.ones(n, bool)
            cmp = {">": a > b, ">=": a >= b, "<": a < b,
                   "<=": a <= b}[op]
            val = ok & np.asarray(cmp, dtype=bool)
            # missing/None/wrong-type -> EvalError -> reject
            return val, ~ok | col.err

        if op in ("IN", "NOT_IN"):
            p = _path_of(node.left)
            if p is None or not isinstance(node.right, ArrayNode):
                return None
            values = [e.value for e in node.right.elements]
            col = cols[_col_key(p)]
            n = len(col.present)
            val = np.zeros(n, bool)
            for lit in values:
                val |= _eq_mask(col, lit)
            if op == "NOT_IN":
                val = ~val
            return val, col.err.copy()

        if op in _STR_OPS:
            p = _path_of(node.left)
            lit = node.right.value if isinstance(node.right, ValueNode) \
                else None
            if p is None or not isinstance(lit, str):
                return None
            col = cols[_col_key(p)]
            n = len(col.present)
            val = np.zeros(n, bool)
            rows = np.flatnonzero(col.is_str)
            if op == "CONTAINS":
                pred = lambda s: lit in s
            elif op == "STARTS_WITH":
                pred = lambda s: s.startswith(lit)
            elif op == "ENDS_WITH":
                pred = lambda s: s.endswith(lit)
            else:  # MATCHES
                try:
                    rx = re.compile(lit)
                except re.error:
                    # invalid pattern errors every string row like the
                    # per-row engine; non-strings error on the type check
                    return np.zeros(n, bool), np.ones(n, bool)
                pred = lambda s: rx.search(s) is not None
            for i in rows:
                if pred(col.strs[i]):
                    val[i] = True
            return val, ~col.is_str | col.err
        return None

    if isinstance(node, FunctionNode):
        if node.name == "EXISTS" and len(node.arguments) == 1:
            p = _path_of(node.arguments[0])
            if p is None:
                return None
            col = cols[_col_key(p)]
            if _is_trivial(p):
                # top-level key: `key in data` (compiler.py exists_top)
                return col.present.copy(), np.zeros(len(col.present), bool)
            # path: any evaluation that doesn't raise counts, including nil
            # from an OOB index (compiler.py exists closure)
            return ~col.err, np.zeros(len(col.err), bool)
        if node.name == "DOES_NOT_EXIST" and len(node.arguments) == 1 and \
                isinstance(node.arguments[0], IdentifierNode):
            col = cols[node.arguments[0].name]
            # non-dict data returns False (compiler.py does_not_exist) —
            # only reachable for ELEMENT columns, whose err marks those
            # rows; document columns never set err on trivial keys
            return ~col.present & ~col.err, \
                np.zeros(len(col.present), bool)
        return None
    return None


class _PathError(Exception):
    """Per-row extraction error — mirrors compiler.EvalError reject-row."""


def _eval_path_steps(data: dict, steps: tuple):
    """Walk one path over a parsed document with the per-row engine's exact
    semantics (compiler.py: ident :88-94, param :106-112, `.` :244-254,
    `[]` :255-264, LENGTH :152-158).  Returns the terminal value (None for
    Go-nil) or raises _PathError where the closure would raise EvalError."""
    v = data
    for st in steps:
        tag = st[0]
        if tag == "id":
            # document roots are always dicts here; ELEMENT roots (inside a
            # quantifier) can be scalars/arrays, where the ident closure
            # raises EvalError (compiler.py:88-94)
            if not isinstance(v, dict):
                raise _PathError
            v = v.get(st[1])  # missing key -> nil, no error
        elif tag == "param":
            if not isinstance(v, dict):
                raise _PathError  # "parameters not provided"
            if st[1] not in v:
                raise _PathError  # "parameter not provided"
            v = v[st[1]]
        elif tag == "key":
            if isinstance(v, dict):
                if st[1] not in v:
                    raise _PathError  # "key not found in map"
                v = v[st[1]]
            elif isinstance(v, list):
                if st[1] != "length":
                    raise _PathError  # "invalid operation on array"
                v = float(len(v))
            else:
                raise _PathError  # '.' on scalar/nil
        elif tag == "idx":
            if not isinstance(v, list):
                raise _PathError  # '[]' on non-array
            i = st[1]
            v = v[i] if 0 <= i < len(v) else None  # OOB -> nil
        else:  # ("len",)
            if not isinstance(v, (str, list, dict)):
                raise _PathError  # LENGTH of unsized value (incl. nil)
            v = float(len(v))
    return v


def _param_column(col: FieldColumn) -> FieldColumn:
    """`:p` resolves against the document map like an identifier, except a
    missing key is an EvalError instead of nil (compiler.py:106-112) — so
    the parameter column IS the field's column plus an absence error mask.
    Mask/value arrays are shared (projections are immutable per
    generation)."""
    pc = FieldColumn(0)
    pc.present = col.present
    pc.is_num = col.is_num
    pc.is_str = col.is_str
    pc.is_bool = col.is_bool
    pc.is_none = col.is_none
    pc.nums = col.nums
    pc.strs = col.strs
    pc.scalar = col.scalar
    pc.err = ~col.present
    return pc


class ColumnarFilterEngine:
    """Owns the per-field projections for one collection; invalidated by
    mutation generation (columns.version)."""

    def __init__(self):
        self._version = -1
        self._cols: dict[str, FieldColumn] = {}
        # a non-dict-JSON metadata row makes EXISTS-family semantics diverge
        # from the global json gate (exists_top returns False without error,
        # compiler.py) — bail to the per-row engine for the whole collection
        self._nondict = False

    def evaluate(self, query: str, columns) -> Optional[np.ndarray]:
        """Boolean keep-mask over columns.size rows, or None to fall back."""
        try:
            ast = parse_query(query)
        except Exception:
            return None
        paths = referenced_paths(ast)
        if paths is None:
            return None
        cols, json_ok = self._project_all(paths, columns)
        if cols is None:
            return None
        apaths: list = []
        _collect_array_paths(ast, apaths)
        if apaths:
            self._project_arrays(apaths, columns)
        out = _vectorize(ast, _Ctx(cols, self, columns))
        if out is None:
            return None
        val, err = out
        return val & ~err & json_ok

    def _project_all(self, paths: set, columns):
        """Column dict keyed by _col_key for every referenced path, plus the
        json-ok row mask; (None, None) to fall back.

        Trivial identifiers and `:param` roots ride the (native-accelerated)
        top-level projection — a parameter column is the root field's column
        with absence turned into a per-row error (compiler.py:106-112).
        Other paths project via one python parse+walk pass, cached per
        (path, mutation generation)."""
        trivial: set = set()
        params: set = set()
        nontrivial = []
        for p in paths:
            if _is_trivial(p):
                trivial.add(p[0][1])
            elif len(p) == 1 and p[0][0] == "param":
                params.add(p[0][1])
            else:
                nontrivial.append(p)
        fields = trivial | params
        if not fields:
            # quantifier-only / array-equality-only query: no top-level
            # scalar fields to project, but the json-ok row mask (and the
            # non-dict-document global fallback) still come from the base
            # projection pass — run it on a dummy never-present field
            fields = {"\x00"}
        base, json_ok = self._project(fields, columns)
        if base is None:
            return None, None
        cols = {f: base[f] for f in trivial}
        for pname in params:
            key = (("param", pname),)
            hit = self._cols.get(key)
            if hit is None:
                hit = self._cols[key] = _param_column(base[pname])
            cols[key] = hit
        if nontrivial:
            pcols = self._project_paths(nontrivial, columns)
            if pcols is None:
                return None, None
            cols.update(pcols)
        return cols, json_ok

    def _project_paths(self, paths: list, columns) -> Optional[dict]:
        """Derived columns for non-trivial paths: ONE pass over the live
        rows parses each document and walks every requested path with the
        per-row engine's exact semantics (_eval_path_steps)."""
        n = columns.size
        missing = [p for p in paths if p not in self._cols]
        if missing:
            built = {p: FieldColumn(n) for p in missing}
            items = list(built.items())
            for row in np.flatnonzero(columns.valid[:n]):
                md = columns.metadata[row]
                try:
                    # parse_int=float: Go decodes every number as float64
                    data = json.loads(md, parse_int=float)
                except Exception:
                    continue  # json_ok (from _project) rejects the row
                if not isinstance(data, dict):
                    self._nondict = True
                    continue
                r = int(row)
                for p, col in items:
                    try:
                        v = _eval_path_steps(data, p)
                    except _PathError:
                        col.err[r] = True
                        continue
                    if v is not None:
                        col.set(r, v)
                    # v is None (missing root / OOB index): leave absent —
                    # every mask treats that exactly like Go-nil
            self._cols.update(built)
        if self._nondict or any(not self._cols[p].scalar for p in paths):
            return None
        return {p: self._cols[p] for p in paths}

    def _project_array(self, path: tuple, columns) -> Optional[ArrayColumn]:
        """Cached CSR element projection of one array-valued path; None
        when the expansion exceeded _ARR_CAP (per-row engine handles it).
        evaluate() pre-projects every array path the query touches in one
        batched pass (_project_arrays), so this is normally a cache hit."""
        hit = self._cols.get(("__arr__", path))
        if hit is None:
            self._project_arrays([path], columns)
            hit = self._cols.get(("__arr__", path))
        return hit if isinstance(hit, ArrayColumn) else None

    def _project_arrays(self, paths: list, columns) -> None:
        """ONE pass over the live rows parses each document once and walks
        every requested array path, flattening list values into CSR element
        arrays (cached per mutation generation).  A path whose expansion
        exceeds _ARR_CAP elements gets a fail sentinel instead."""
        missing = [p for p in dict.fromkeys(paths)
                   if ("__arr__", p) not in self._cols]
        if not missing:
            return
        n = columns.size

        class _Acc:
            __slots__ = ("arr", "kinds", "nums", "strs", "total", "failed")

            def __init__(self):
                self.arr = ArrayColumn(n)
                self.kinds: list = []
                self.nums: list = []
                self.strs: list = []
                self.total = 0
                self.failed = False

        accs = {p: _Acc() for p in missing}
        items = list(accs.items())
        for row in np.flatnonzero(columns.valid[:n]):
            r = int(row)
            md = columns.metadata[r]
            try:
                data = json.loads(md, parse_int=float)
            except Exception:
                data = None  # json_ok also rejects the row
            if data is not None and not isinstance(data, dict):
                self._nondict = True
                data = None
            for p, a in items:
                if a.failed:
                    continue
                arr = a.arr
                if data is None:
                    arr.err[r] = True
                    arr.starts[r + 1] = a.total
                    continue
                try:
                    v = _eval_path_steps(data, p)
                except _PathError:
                    arr.err[r] = True
                    arr.starts[r + 1] = a.total
                    continue
                if isinstance(v, list):
                    arr.is_list[r] = True
                    a.total += len(v)
                    if a.total > _ARR_CAP:
                        a.failed = True
                        continue
                    arr.elems.extend(v)
                    for e in v:
                        if isinstance(e, bool):
                            a.kinds.append(_K_BOOL)
                            a.nums.append(1.0 if e else 0.0)
                            a.strs.append(None)
                        elif isinstance(e, (int, float)):
                            a.kinds.append(_K_NUM)
                            a.nums.append(float(e))
                            a.strs.append(None)
                        elif isinstance(e, str):
                            a.kinds.append(_K_STR)
                            a.nums.append(0.0)
                            a.strs.append(e)
                        elif e is None:
                            a.kinds.append(_K_NULL)
                            a.nums.append(0.0)
                            a.strs.append(None)
                        else:
                            a.kinds.append(_K_COMPLEX)
                            a.nums.append(0.0)
                            a.strs.append(None)
                arr.starts[r + 1] = a.total
        for p, a in items:
            if a.failed:
                self._cols[("__arr__", p)] = False  # per-generation sentinel
                continue
            arr = a.arr
            # rows skipped by the loop (invalid) inherit the running offset
            np.maximum.accumulate(arr.starts, out=arr.starts)
            arr.kinds = np.asarray(a.kinds, np.int8)
            arr.nums = np.asarray(a.nums, np.float64)
            arr.strs = np.asarray(a.strs, object)
            arr.rowidx = np.repeat(np.arange(n, dtype=np.int64),
                                   arr.lengths)
            self._cols[("__arr__", p)] = arr

    def _dyn_col(self, dyn: tuple, ctx) -> Optional[FieldColumn]:
        """Derived column for a dynamic array index `arr[i]` (cached per
        generation): the array's CSR projection gathered at each row's own
        index value.  None when the array projection overflowed or the
        element values are non-scalar (caller falls back)."""
        apath, ipath = dyn
        key = ("__dynidx__", apath, ipath)
        col = self._cols.get(key)
        if col is not None:
            return col if isinstance(col, FieldColumn) else None
        arr = self._project_array(apath, ctx.columns)
        if arr is None:
            self._cols[key] = False
            return None
        idx = ctx.cols.get(_col_key(ipath))
        if idx is None:
            self._cols[key] = False
            return None
        col = _dyn_index_column(arr, idx)
        if not col.scalar:
            self._cols[key] = False
            return None
        self._cols[key] = col
        return col

    def _elem_cols(self, apath: tuple, arr: ArrayColumn,
                   cpaths: set) -> dict:
        """FieldColumns over the flattened ELEMENT space for the condition's
        paths (roots resolve against each element, compiler.py quantifier
        closure), cached per (array path, element path, generation)."""
        out = {}
        missing = []
        for p in cpaths:
            key = ("__elem__", apath, p)
            col = self._cols.get(key)
            if col is None:
                missing.append(p)
            else:
                out[_col_key(p)] = col
        if missing:
            m = len(arr.elems)
            built = {p: FieldColumn(m) for p in missing}
            items = list(built.items())
            for i, e in enumerate(arr.elems):
                for p, col in items:
                    if len(p) == 1 and p[0][0] == "id":
                        # trivial key: EXISTS(x) on elements is exists_top
                        # (`key in element`), so an explicit null must
                        # project as present+is_none, not absent
                        if isinstance(e, dict):
                            if p[0][1] in e:
                                col.set(i, e[p[0][1]])
                        else:
                            col.err[i] = True  # ident on scalar/array
                        continue
                    try:
                        v = _eval_path_steps(e, p)
                    except _PathError:
                        col.err[i] = True
                        continue
                    if v is not None:
                        col.set(i, v)
            for p, col in items:
                self._cols[("__elem__", apath, p)] = col
                out[_col_key(p)] = col
        return out

    def _vectorize_quantifier(self, node, columns) -> Optional[tuple]:
        """ANY/ALL as a segment reduction: vectorize the condition over the
        (row, position)-expanded elements, then bincount matches per row.
        Per-row parity (compiler.py:118-137): a condition error on an
        element means "no match" (not row rejection); a non-list array
        value rejects the row; ANY of [] is False, ALL of [] is True."""
        if _contains_quantifier(node.condition):
            return None
        apath = _quant_array_path(node)
        if apath is None:
            return None
        cpaths = referenced_paths(node.condition)
        if cpaths is None:
            return None
        arr = self._project_array(apath, columns)
        if arr is None:
            return None
        ecols = self._elem_cols(apath, arr, cpaths)
        for p in cpaths:  # element columns are always "projected": any
            # non-scalar terminal just never matches scalar predicates
            if not ecols[_col_key(p)].scalar:
                return None
        ev = _vectorize(node.condition, _Ctx(ecols))
        if ev is None:
            return None
        match = ev[0] & ~ev[1]
        n = len(arr.is_list)
        counts = np.bincount(arr.rowidx[match], minlength=n)
        if isinstance(node, AnyNode):
            val = counts > 0
        else:
            val = counts == arr.lengths
        err = arr.err | ~arr.is_list
        return val, err

    def _project_native(self, fields: list, columns) -> bool:
        """Project `fields` with the C extractor; True on success.

        Rows the C parser flags (escapes in relevant strings, exotic
        literals, broken JSON, non-object docs) are re-parsed by python so
        semantics stay identical to the pure-python path."""
        try:
            from ..native import jp_extract
        except Exception:
            return False
        n = columns.size
        live = columns.valid[:n]
        if getattr(columns, "metadata_resident", True):
            docs = [columns.metadata[r] if live[r] else None
                    for r in range(n)]
            out = jp_extract(docs, fields)
            if out is None:
                return False
            kinds, nums, strs, flags = out
        else:
            # out-of-core metadata: never hold every row's bytes at once —
            # fetch + project in bounded chunks (the mode exists because
            # the full metadata may exceed host RAM)
            kinds = nums = strs = flags = None
            chunk = _OOC_PROJECT_CHUNK
            for s in range(0, n, chunk):
                e = min(n, s + chunk)
                docs = [columns.metadata[r] if live[r] else None
                        for r in range(s, e)]
                part = jp_extract(docs, fields)
                if part is None:
                    return False
                if kinds is None:
                    kinds = np.empty((n,) + part[0].shape[1:],
                                     part[0].dtype)
                    nums = np.empty((n,) + part[1].shape[1:],
                                    part[1].dtype)
                    strs = np.empty((n,) + part[2].shape[1:], object)
                    flags = np.empty((n,) + part[3].shape[1:],
                                     part[3].dtype)
                kinds[s:e], nums[s:e], strs[s:e], flags[s:e] = part
            if kinds is None:  # n == 0
                out = jp_extract([], fields)
                if out is None:
                    return False
                kinds, nums, strs, flags = out

        build_ok = "" not in self._cols
        json_ok = self._cols.get("") or FieldColumn(n)
        for i, f in enumerate(fields):
            col = FieldColumn(n)
            k = kinds[:, i]
            col.present = k != 0
            col.is_num = k == 1
            col.is_str = k == 2
            col.is_bool = k == 3
            col.is_none = k == 4
            col.nums = nums[:, i].copy()
            col.strs = strs[:, i].copy()
            col.scalar = not bool((k == 5).any())
            self._cols[f] = col
        ok_rows = (flags == 0) & live
        if build_ok:
            json_ok.present[:] = False
            json_ok.present[ok_rows] = True
            self._cols[""] = json_ok

        # python fallback for flagged live rows (rare: escapes, NaN, broken).
        # Reset the row's masks FIRST: a flagged row may carry partial native
        # state (e.g. is_str with strs=None when only the escape decode was
        # the problem), and a failed re-parse must leave it fully absent or
        # string predicates crash on the poisoned entry.
        for r in np.flatnonzero((flags == 1) & live):
            r = int(r)
            for f in fields:
                col = self._cols[f]
                col.present[r] = col.is_num[r] = col.is_str[r] = False
                col.is_bool[r] = col.is_none[r] = False
                col.strs[r] = None
            try:
                data = json.loads(columns.metadata[r], parse_int=float)
            except Exception:
                json_ok.present[r] = False
                continue
            if not isinstance(data, dict):
                self._nondict = True
                json_ok.present[r] = False
                continue
            json_ok.present[r] = True
            for f in fields:
                if f in data:
                    self._cols[f].set(r, data[f])
        return True

    def _project(self, fields: set, columns):
        """Projection strategies, fastest available first:

        1. native (native/jsonproj.cpp via the port's native.jp_extract):
           one C pass over the concatenated docs extracts the REQUESTED
           fields ~10x faster than json.loads; rows the C parser can't
           handle with exact python semantics are re-parsed by python.
        2. pure python: ONE json pass per mutation generation projects
           EVERY top-level key it encounters (amortized across all fields
           any future query touches)."""
        if self._version != columns.version:
            self._cols.clear()
            self._nondict = False
            self._version = columns.version
        n = columns.size
        missing = [f for f in fields if f not in self._cols]
        if missing or "" not in self._cols:
            if self._project_native(missing or list(fields), columns):
                for f in fields:
                    self._cols.setdefault(f, FieldColumn(n))
                if self._nondict or \
                        any(not self._cols[f].scalar for f in fields):
                    return None, None
                return ({f: self._cols[f] for f in fields},
                        self._cols[""].present)
            elif missing and "" in self._cols:
                # native projected an earlier query's fields this generation
                # but can't project the NEW fields — drop the cache so the
                # full python pass below re-projects everything; otherwise
                # the missing fields would silently default to all-absent
                # columns (wrong filter results, not a fallback)
                self._cols.clear()
                self._nondict = False
        if "" not in self._cols:
            cols: dict[str, FieldColumn] = {}
            json_ok = FieldColumn(n)  # .present doubles as json-ok mask
            for row in np.flatnonzero(columns.valid[:n]):
                md = columns.metadata[row]
                try:
                    # None/empty bytes raise, exactly like the per-row
                    # engine's json.loads -> EvalError -> reject
                    data = json.loads(md, parse_int=float)
                except Exception:
                    continue  # json_ok stays False -> row rejected
                if not isinstance(data, dict):
                    self._nondict = True
                    continue
                json_ok.present[row] = True
                r = int(row)
                for key, value in data.items():
                    col = cols.get(key)
                    if col is None:
                        col = cols[key] = FieldColumn(n)
                    col.set(r, value)
            self._cols = cols
            self._cols[""] = json_ok
        # a field no document carries: all-absent column
        for f in fields:
            self._cols.setdefault(f, FieldColumn(n))
        if self._nondict or any(not self._cols[f].scalar for f in fields):
            return None, None
        return {f: self._cols[f] for f in fields}, self._cols[""].present

"""Query AST -> filter closure compiler.

Semantics parity with the reference compiler (the Go project's query/compiler.go):

* `==`/`!=` are deep equality (compiler.go:173-176); all JSON numbers are
  decoded as floats (Go json.Unmarshal decodes every number to float64) so
  `age == 30` matches `{"age": 30}`.
* `> >= < <=` compare numbers with numbers and strings with strings;
  mixed types raise (compiler.go:268-322).
* AND requires boolean operands; OR short-circuits on a true left operand
  before type-checking the right (compiler.go:188-199).
* `.` on a map raises for a missing key (-> filter false via the error path,
  compiler.go:225-233); a missing *top-level* identifier evaluates to None
  without error (compiler.go:436-441 map lookup).
* `.length` on an array returns its length as a float (compiler.go:239-243).
* `arr[i]` returns None when out of bounds (compiler.go:257-260).
* CONTAINS/STARTS_WITH/ENDS_WITH require strings; MATCHES uses regex search
  semantics of Go's regexp.MatchString (unanchored).
* IN/NOT IN deep-compare against a literal array.
* EXISTS/DOES_NOT_EXIST on a top-level key check key presence; DOES NOT EXIST
  on a nested path is an error in the reference (compiler.go:66-69) and here.
* `:param` placeholders resolve against the data map (parameters are the
  record in the reference, query/compiler.go:80-91).

Documented deviation: LENGTH() returns a float (the reference returns a Go
int, making `LENGTH(x) == 3` unsatisfiable since DeepEqual(int,float64) is
false — compiler.go:363-370); float makes equality usable and `>`-family
comparisons behave identically.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable

from .parser import (AllNode, AnyNode, ArrayNode, ArrayStarNode,
                     ExpressionNode, FunctionNode, IdentifierNode, Node,
                     ParameterNode, QueryError, ValueNode)

Compiled = Callable[[Any], Any]


class EvalError(ValueError):
    pass


def _deep_equal(a: Any, b: Any) -> bool:
    # bool is not equal to number (Go types differ)
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool):
        return float(a) == float(b)
    if type(a) is not type(b) and not (a is None or b is None):
        return False
    return a == b


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def compile_expression(node: Node | None) -> Compiled:
    if node is None:
        return lambda data: None

    if isinstance(node, ExpressionNode):
        left = compile_expression(node.left) if node.left is not None else None
        if node.operator == ".":
            if not isinstance(node.right, IdentifierNode):
                raise QueryError("right side of '.' must be an identifier")
            field_name = node.right.name
            right: Compiled = lambda data: field_name
        else:
            right = compile_expression(node.right)
        op = node.operator

        def run(data: Any) -> Any:
            lval = left(data) if left is not None else None
            rval = right(data)
            return _evaluate_operation(op, lval, rval)
        return run

    if isinstance(node, IdentifierNode):
        name = node.name

        def ident(data: Any) -> Any:
            if isinstance(data, dict):
                return data.get(name)  # missing -> None, no error
            if isinstance(data, list):
                raise EvalError("cannot use dot notation on array")
            raise EvalError(f"cannot access field {name} on {type(data).__name__}")
        return ident

    if isinstance(node, ValueNode):
        value = node.value
        return lambda data: value

    if isinstance(node, FunctionNode):
        return _compile_function(node)

    if isinstance(node, ParameterNode):
        pname = node.name

        def param(data: Any) -> Any:
            if not isinstance(data, dict):
                raise EvalError("parameters not provided")
            if pname not in data:
                raise EvalError(f"parameter {pname} not provided")
            return data[pname]
        return param

    if isinstance(node, ArrayNode):
        elems = [compile_expression(e) for e in node.elements]
        return lambda data: [e(data) for e in elems]

    if isinstance(node, AnyNode) or isinstance(node, AllNode):
        arr_expr = compile_expression(node.array)
        cond = compile_expression(node.condition)
        want_any = isinstance(node, AnyNode)

        def quantifier(data: Any) -> bool:
            arr = arr_expr(data)
            if not isinstance(arr, list):
                raise EvalError(f"expected array, got {type(arr).__name__}")
            for item in arr:
                try:
                    match = cond(item)
                except EvalError:
                    match = False
                if want_any and match is True:
                    return True
                if not want_any and match is not True:
                    return False
            return not want_any
        return quantifier

    if isinstance(node, ArrayStarNode):
        return compile_expression(node.array)

    raise QueryError(f"unsupported node type: {type(node).__name__}")


def _compile_function(node: FunctionNode) -> Compiled:
    name = node.name
    if name == "LENGTH":
        if len(node.arguments) != 1:
            raise QueryError("LENGTH function requires exactly one argument")
        arg = compile_expression(node.arguments[0])

        def length(data: Any) -> float:
            v = arg(data)
            if isinstance(v, (str, list, dict)):
                return float(len(v))
            raise EvalError(
                f"LENGTH function not supported for type {type(v).__name__}")
        return length

    if name == "EXISTS":
        if len(node.arguments) != 1:
            raise QueryError("EXISTS function requires exactly one argument")
        argnode = node.arguments[0]
        if isinstance(argnode, IdentifierNode):
            key = argnode.name

            def exists_top(data: Any) -> bool:
                return isinstance(data, dict) and key in data
            return exists_top
        arg = compile_expression(argnode)

        def exists(data: Any) -> bool:
            # nested path: missing segments raise -> not exists
            # (mirrors the reference where `.` errors on a missing key,
            # compiler.go:225-233 + evaluateFunction EXISTS err==nil check)
            try:
                arg(data)
                return True
            except EvalError:
                return False
        return exists

    if name == "DOES_NOT_EXIST":
        if len(node.arguments) != 1:
            raise QueryError(
                "DOES_NOT_EXIST function requires exactly one argument")
        argnode = node.arguments[0]
        if not isinstance(argnode, IdentifierNode):
            raise QueryError(
                "DOES_NOT_EXIST function argument must be an identifier")
        key = argnode.name

        def does_not_exist(data: Any) -> bool:
            if not isinstance(data, dict):
                return False
            return key not in data
        return does_not_exist

    raise QueryError(f"unsupported function: {name}")


def _evaluate_operation(op: str, left: Any, right: Any) -> Any:
    if op == "==":
        return _deep_equal(left, right)
    if op == "!=":
        return not _deep_equal(left, right)
    if op in (">", ">=", "<", "<="):
        return _compare(op, left, right)
    if op == "AND":
        if not isinstance(left, bool) or not isinstance(right, bool):
            raise EvalError("AND operation requires boolean operands")
        return left and right
    if op == "OR":
        if not isinstance(left, bool):
            raise EvalError("OR operation requires boolean operands")
        if left:
            return True  # short-circuit (compiler.go:193-195)
        if not isinstance(right, bool):
            raise EvalError("OR operation requires boolean operands")
        return right
    if op == "NOT":
        if not isinstance(right, bool):
            raise EvalError("NOT operation requires a boolean operand")
        return not right
    if op == "IN":
        return _evaluate_in(left, right)
    if op == "NOT_IN":
        return not _evaluate_in(left, right)
    if op == "CONTAINS":
        _require_strings(op, left, right)
        return right in left
    if op == "STARTS_WITH":
        _require_strings(op, left, right)
        return left.startswith(right)
    if op == "ENDS_WITH":
        _require_strings(op, left, right)
        return left.endswith(right)
    if op == "MATCHES":
        _require_strings(op, left, right)
        try:
            return re.search(right, left) is not None
        except re.error as exc:
            raise EvalError(f"invalid regex pattern: {exc}") from exc
    if op == ".":
        if isinstance(left, dict):
            if right not in left:
                raise EvalError(f"key '{right}' not found in map")
            return left[right]
        if isinstance(left, list):
            if right == "length":
                return float(len(left))
            raise EvalError(f"invalid operation on array: {right}")
        raise EvalError(
            f"left operand of '.' must be a map or array, got {type(left).__name__}")
    if op == "[]":
        if not isinstance(left, list):
            raise EvalError(
                f"left operand of '[]' must be an array, got {type(left).__name__}")
        if not _is_number(right):
            raise EvalError("right operand of '[]' must be a number")
        idx = int(round(float(right)))
        if idx < 0 or idx >= len(left):
            return None  # out of bounds -> nil (compiler.go:257-260)
        return left[idx]
    raise EvalError(f"unsupported operator: {op}")


def _require_strings(op: str, left: Any, right: Any) -> None:
    if not isinstance(left, str) or not isinstance(right, str):
        raise EvalError(f"{op} operation requires string operands")


def _compare(op: str, left: Any, right: Any) -> bool:
    if _is_number(left) and _is_number(right):
        lv, rv = float(left), float(right)
    elif isinstance(left, str) and isinstance(right, str):
        lv, rv = left, right
    else:
        raise EvalError(f"unsupported comparison: {left!r} {op} {right!r}")
    return {">": lv > rv, ">=": lv >= rv, "<": lv < rv, "<=": lv <= rv}[op]


def _evaluate_in(left: Any, right: Any) -> bool:
    if not isinstance(right, list):
        raise EvalError("IN operator requires a list on the right side")
    return any(_deep_equal(left, item) for item in right)


def create_filter_function(compiled: Compiled) -> Callable[[bytes], bool]:
    """bytes(JSON) -> bool; raises on JSON/eval/type errors
    (query/query.go:11-32 + compiler.go CreateFilterFunction)."""
    def filter_fn(record: bytes) -> bool:
        try:
            # parse_int=float: Go decodes every JSON number as float64
            data = json.loads(record, parse_int=float)
        except json.JSONDecodeError as exc:
            raise EvalError(f"failed to unmarshal JSON: {exc}") from exc
        result = compiled(data)
        if not isinstance(result, bool):
            raise EvalError(f"query result is not a boolean: {result!r}")
        return result
    return filter_fn


def filter_function_from_query(query: str) -> Callable[[bytes], bool]:
    from .parser import parse_query
    return create_filter_function(compile_expression(parse_query(query)))

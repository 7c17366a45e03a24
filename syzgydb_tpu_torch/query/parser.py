"""Query language parser -> AST.

Grammar parity with the reference parser (the Go project's query/parser.go):
precedence OR < AND < comparison < NOT < primary, dotted paths and array
indexing as left-associative postfix (parser.go:327-360), IN/NOT IN with
literal arrays (parser.go:369-406), postfix EXISTS / DOES NOT EXIST
(parser.go:226-236), `:param` placeholders (parser.go:462-470).

Extension over the reference: ANY(...)/ALL(...) are parseable here — the
reference defines their AST nodes and compiler semantics but its grammar
productions are commented out (parser.go:278-326), so the syntax errors out
there.  Accepted forms: ANY(arr[*] condition) / ANY(arr[*], condition); the
condition is evaluated against each array element.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .lexer import Lexer, T


class QueryError(ValueError):
    pass


class Node:
    pass


@dataclass
class ExpressionNode(Node):
    left: Optional[Node]
    operator: str
    right: Node

    def __str__(self) -> str:
        if self.left is None:
            return f"{self.operator}({self.right})"
        return f"{self.operator}({self.left}, {self.right})"


@dataclass
class IdentifierNode(Node):
    name: str

    def __str__(self) -> str:
        return self.name


@dataclass
class ValueNode(Node):
    value: Any

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        if isinstance(self.value, bool):
            return "true" if self.value else "false"
        if self.value is None:
            return "<nil>"
        return repr(self.value) if not isinstance(self.value, float) else (
            str(int(self.value)) if self.value == int(self.value)
            else str(self.value))


@dataclass
class FunctionNode(Node):
    name: str
    arguments: list[Node] = field(default_factory=list)

    def __str__(self) -> str:
        return f"{self.name}({', '.join(str(a) for a in self.arguments)})"


@dataclass
class ParameterNode(Node):
    name: str

    def __str__(self) -> str:
        return ":" + self.name


@dataclass
class ArrayNode(Node):
    elements: list[Node] = field(default_factory=list)

    def __str__(self) -> str:
        return f"[{', '.join(str(e) for e in self.elements)}]"


@dataclass
class AnyNode(Node):
    array: Node
    condition: Node

    def __str__(self) -> str:
        return f"ANY({self.array} {self.condition})"


@dataclass
class AllNode(Node):
    array: Node
    condition: Node

    def __str__(self) -> str:
        return f"ALL({self.array} {self.condition})"


@dataclass
class ArrayStarNode(Node):
    array: Node

    def __str__(self) -> str:
        return f"{self.array}[*]"


_COMPARISON = {T.EQ, T.NEQ, T.GT, T.GTE, T.LT, T.LTE, T.IN, T.NOT_IN,
               T.CONTAINS, T.STARTS_WITH, T.ENDS_WITH, T.MATCHES, T.EXISTS,
               T.DOES_NOT_EXIST}


class Parser:
    def __init__(self, lexer: Lexer):
        self._lexer = lexer
        self.cur = lexer.next_token()
        self.peek = lexer.next_token()

    def _next(self) -> None:
        self.cur = self.peek
        self.peek = self._lexer.next_token()

    def parse(self) -> Node:
        node = self._parse_or()
        if self.cur.type != T.EOF:
            raise QueryError(f"unexpected token: {self.cur.literal}")
        return node

    # OrExpression := AndExpression (OR AndExpression)*
    def _parse_or(self) -> Node:
        left = self._parse_and()
        while self.cur.type == T.OR:
            self._next()
            left = ExpressionNode(left, "OR", self._parse_and())
        return left

    # AndExpression := ComparisonExpression (AND ComparisonExpression)*
    def _parse_and(self) -> Node:
        left = self._parse_comparison()
        while self.cur.type == T.AND:
            self._next()
            left = ExpressionNode(left, "AND", self._parse_comparison())
        return left

    # ComparisonExpression := NotExpression (CmpOp NotExpression)?
    def _parse_comparison(self) -> Node:
        left = self._parse_not()
        if self.cur.type in _COMPARISON:
            op = self.cur.literal
            self._next()
            return ExpressionNode(left, op, self._parse_not())
        return left

    # NotExpression := NOT? PrimaryExpression
    def _parse_not(self) -> Node:
        if self.cur.type == T.NOT:
            self._next()
            return ExpressionNode(None, "NOT", self._parse_primary())
        return self._parse_primary()

    def _parse_primary(self) -> Node:
        t = self.cur.type
        if t == T.IDENT:
            return self._parse_identifier_or_function()
        if t == T.LENGTH:
            # LENGTH(expr): keyword token acting as function name
            name = self.cur.literal
            self._next()
            return self._parse_function(IdentifierNode(name))
        if t in (T.ANY, T.ALL):
            return self._parse_any_all()
        if t == T.NUMBER:
            return self._parse_number()
        if t == T.STRING:
            v = self.cur.literal
            self._next()
            return ValueNode(v)
        if t == T.BOOLEAN:
            v = self.cur.literal == "true"
            self._next()
            return ValueNode(v)
        if t == T.NULL:
            self._next()
            return ValueNode(None)
        if t == T.LPAREN:
            self._next()
            node = self._parse_or()
            if self.cur.type != T.RPAREN:
                raise QueryError(f"expected ')', got {self.cur.literal}")
            self._next()
            return node
        if t == T.LBRACKET:
            return self._parse_array_literal()
        if t == T.COLON:
            return self._parse_parameter()
        raise QueryError(f"unexpected token: {self.cur.literal}")

    def _parse_identifier_or_function(self) -> Node:
        expr = self._parse_array_access_or_identifier()
        if self.cur.type in (T.IN, T.NOT):
            return self._parse_in(expr)
        if self.cur.type == T.LPAREN:
            return self._parse_function(expr)
        if self.cur.type == T.EXISTS:
            self._next()
            return FunctionNode("EXISTS", [expr])
        if self.cur.type == T.DOES_NOT_EXIST:
            self._next()
            return FunctionNode("DOES_NOT_EXIST", [expr])
        return expr

    def _parse_function(self, expr: Node) -> Node:
        if not isinstance(expr, IdentifierNode):
            raise QueryError(f"expected function name, got {type(expr).__name__}")
        self._next()  # consume '('
        args: list[Node] = []
        if self.cur.type != T.RPAREN:
            args.append(self._parse_or())
            while self.cur.type == T.COMMA:
                self._next()
                args.append(self._parse_or())
        if self.cur.type != T.RPAREN:
            raise QueryError(
                f"expected ')' after function arguments, got {self.cur.literal}")
        self._next()
        return FunctionNode(expr.name, args)

    def _parse_any_all(self) -> Node:
        is_any = self.cur.type == T.ANY
        self._next()
        if self.cur.type != T.LPAREN:
            raise QueryError(
                f"expected '(' after {'ANY' if is_any else 'ALL'}")
        self._next()
        array = self._parse_array_access_or_identifier()
        if self.cur.type == T.ARRAY_STAR:
            self._next()
            array = ArrayStarNode(array)
        if self.cur.type == T.COMMA:
            self._next()
        condition = self._parse_or()
        if self.cur.type != T.RPAREN:
            raise QueryError(f"expected ')', got {self.cur.literal}")
        self._next()
        return AnyNode(array, condition) if is_any else AllNode(array, condition)

    def _parse_array_access_or_identifier(self) -> Node:
        expr: Node = self._parse_identifier()
        while self.cur.type in (T.LBRACKET, T.DOT):
            if self.cur.type == T.LBRACKET:
                self._next()
                index = self._parse_or()
                if self.cur.type != T.RBRACKET:
                    raise QueryError(f"expected ']', got {self.cur.literal}")
                self._next()
                expr = ExpressionNode(expr, "[]", index)
            else:
                self._next()
                if self.cur.type != T.IDENT:
                    raise QueryError(
                        f"expected identifier after '.', got {self.cur.literal}")
                expr = ExpressionNode(expr, ".", IdentifierNode(self.cur.literal))
                self._next()
        return expr

    def _parse_identifier(self) -> IdentifierNode:
        if self.cur.type != T.IDENT:
            raise QueryError(f"expected identifier, got {self.cur.literal}")
        node = IdentifierNode(self.cur.literal)
        self._next()
        return node

    def _parse_in(self, expr: Node) -> Node:
        op = "IN"
        if self.cur.type == T.NOT:
            self._next()
            if self.cur.type != T.IN:
                raise QueryError(f"expected IN after NOT, got {self.cur.literal}")
            op = "NOT_IN"
        self._next()  # consume IN
        if self.cur.type != T.LBRACKET:
            raise QueryError(
                f"expected '[' after IN/NOT IN, got {self.cur.literal}")
        return ExpressionNode(expr, op, self._parse_array_literal())

    def _parse_array_literal(self) -> ArrayNode:
        self._next()  # consume '['
        elements: list[Node] = []
        if self.cur.type != T.RBRACKET:
            elements.append(self._parse_array_element())
            while self.cur.type == T.COMMA:
                self._next()
                elements.append(self._parse_array_element())
        if self.cur.type != T.RBRACKET:
            raise QueryError(f"expected ']', got {self.cur.literal}")
        self._next()
        return ArrayNode(elements)

    def _parse_array_element(self) -> Node:
        if self.cur.type == T.NUMBER:
            return self._parse_number()
        if self.cur.type == T.STRING:
            v = self.cur.literal
            self._next()
            return ValueNode(v)
        raise QueryError(
            f"expected number or string in array, got {self.cur.literal}")

    def _parse_parameter(self) -> ParameterNode:
        self._next()  # consume ':'
        if self.cur.type != T.IDENT:
            raise QueryError(
                f"expected identifier after ':', got {self.cur.literal}")
        node = ParameterNode(self.cur.literal)
        self._next()
        return node

    def _parse_number(self) -> ValueNode:
        lit = self.cur.literal
        try:
            value = float(int(lit, 16)) if lit[:2].lower() == "0x" else float(lit)
        except ValueError as exc:
            raise QueryError(f"could not parse number: {lit}") from exc
        self._next()
        return ValueNode(value)


def parse_query(text: str) -> Node:
    return Parser(Lexer(text)).parse()

"""Metadata filter query language (the Go reference project's query/ package).

String -> FilterFunction pipeline: Lexer -> Parser -> AST -> closure compiler
-> per-record JSON filter (query/query.go:11-32).
"""

from .compiler import (EvalError, compile_expression, create_filter_function,
                       filter_function_from_query)
from .lexer import Lexer, T, Token
from .parser import (AllNode, AnyNode, ArrayNode, ArrayStarNode,
                     ExpressionNode, FunctionNode, IdentifierNode, Node,
                     ParameterNode, Parser, QueryError, ValueNode, parse_query)

__all__ = [
    "Lexer", "Token", "T", "Parser", "parse_query", "Node", "QueryError",
    "EvalError", "ExpressionNode", "IdentifierNode", "ValueNode",
    "FunctionNode", "ParameterNode", "ArrayNode", "AnyNode", "AllNode",
    "ArrayStarNode", "compile_expression", "create_filter_function",
    "filter_function_from_query",
]

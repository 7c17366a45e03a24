"""Query language lexer.

Token-level parity with the reference lexer (the Go project's query/lexer.go):
same token set, the two-word `DOES NOT EXIST` keyword (lexer.go:173-189),
hex and float literals with exponents (lexer.go:254-293), single- or
double-quoted strings with escapes (lexer.go:314-347), and `[*]` as a single
token (lexer.go:130-136).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class T(enum.Enum):
    IDENT = "IDENT"
    STRING = "STRING"
    NUMBER = "NUMBER"
    BOOLEAN = "BOOLEAN"
    NULL = "NULL"
    OPERATOR = "OPERATOR"
    LPAREN = "LPAREN"
    RPAREN = "RPAREN"
    COMMA = "COMMA"
    EQ = "EQ"
    NEQ = "NEQ"
    GT = "GT"
    GTE = "GTE"
    LT = "LT"
    LTE = "LTE"
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    IN = "IN"
    NOT_IN = "NOT_IN"
    EXISTS = "EXISTS"
    DOES_NOT_EXIST = "DOES_NOT_EXIST"
    CONTAINS = "CONTAINS"
    STARTS_WITH = "STARTS_WITH"
    ENDS_WITH = "ENDS_WITH"
    MATCHES = "MATCHES"
    LENGTH = "LENGTH"
    ANY = "ANY"
    ALL = "ALL"
    EOF = "EOF"
    LBRACKET = "LBRACKET"
    RBRACKET = "RBRACKET"
    COLON = "COLON"
    DOT = "DOT"
    ARRAY_STAR = "ARRAY_STAR"


_KEYWORDS = {
    "AND": T.AND, "OR": T.OR, "NOT": T.NOT, "IN": T.IN,
    "DOES NOT EXIST": T.DOES_NOT_EXIST, "EXISTS": T.EXISTS,
    "CONTAINS": T.CONTAINS, "STARTS_WITH": T.STARTS_WITH,
    "ENDS_WITH": T.ENDS_WITH, "MATCHES": T.MATCHES, "LENGTH": T.LENGTH,
    "ANY": T.ANY, "ALL": T.ALL, "null": T.NULL,
    "true": T.BOOLEAN, "false": T.BOOLEAN,
}


@dataclass
class Token:
    type: T
    literal: str
    line: int = 1
    column: int = 0


def _is_letter(ch: str) -> bool:
    return ch.isascii() and (ch.isalpha() or ch == "_")


def _is_digit(ch: str) -> bool:
    return ch.isascii() and ch.isdigit()


def _is_hex(ch: str) -> bool:
    return _is_digit(ch) or ch.lower() in "abcdef"


class Lexer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.line = 1
        self.col = 0

    def _ch(self, offset: int = 0) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else "\0"

    def _advance(self, n: int = 1) -> None:
        for _ in range(n):
            if self.pos < len(self.text) and self.text[self.pos] == "\n":
                self.line += 1
                self.col = 0
            else:
                self.col += 1
            self.pos += 1

    def tokens(self) -> list[Token]:
        out = []
        while True:
            tok = self.next_token()
            out.append(tok)
            if tok.type == T.EOF:
                return out

    def next_token(self) -> Token:
        while self._ch() in " \t\n\r" and self._ch() != "\0":
            self._advance()
        ch = self._ch()
        line, col = self.line, self.col
        if ch == "\0":
            return Token(T.EOF, "", line, col)

        two = ch + self._ch(1)
        if two == "==":
            self._advance(2)
            return Token(T.EQ, "==", line, col)
        if two == "!=":
            self._advance(2)
            return Token(T.NEQ, "!=", line, col)
        if two == ">=":
            self._advance(2)
            return Token(T.GTE, ">=", line, col)
        if two == "<=":
            self._advance(2)
            return Token(T.LTE, "<=", line, col)
        if ch == ">":
            self._advance()
            return Token(T.GT, ">", line, col)
        if ch == "<":
            self._advance()
            return Token(T.LT, "<", line, col)
        if ch == "(":
            self._advance()
            return Token(T.LPAREN, "(", line, col)
        if ch == ")":
            self._advance()
            return Token(T.RPAREN, ")", line, col)
        if ch == ",":
            self._advance()
            return Token(T.COMMA, ",", line, col)
        if ch == "[":
            if self._ch(1) == "*" and self._ch(2) == "]":
                self._advance(3)
                return Token(T.ARRAY_STAR, "[*]", line, col)
            self._advance()
            return Token(T.LBRACKET, "[", line, col)
        if ch == "]":
            self._advance()
            return Token(T.RBRACKET, "]", line, col)
        if ch == ":":
            self._advance()
            return Token(T.COLON, ":", line, col)
        if ch == ".":
            self._advance()
            return Token(T.DOT, ".", line, col)
        if ch in "\"'":
            return Token(T.STRING, self._read_string(ch), line, col)
        if _is_letter(ch):
            word = self._read_identifier_or_keyword()
            return Token(_KEYWORDS.get(word, T.IDENT), word, line, col)
        if _is_digit(ch):
            return Token(T.NUMBER, self._read_number(), line, col)
        self._advance()
        return Token(T.OPERATOR, ch, line, col)

    def _read_identifier_or_keyword(self) -> str:
        start = self.pos
        while _is_letter(self._ch()) or _is_digit(self._ch()):
            self._advance()
        word = self.text[start:self.pos]
        # two-word keyword `DOES NOT EXIST` (lexer.go:173-189)
        if word == "DOES" and self._ch() == " ":
            save_pos, save_line, save_col = self.pos, self.line, self.col
            self._advance()
            if self._read_word() == "NOT" and self._ch() == " ":
                self._advance()
                if self._read_word() == "EXIST":
                    return "DOES NOT EXIST"
            self.pos, self.line, self.col = save_pos, save_line, save_col
        return word

    def _read_word(self) -> str:
        start = self.pos
        while _is_letter(self._ch()):
            self._advance()
        return self.text[start:self.pos]

    def _read_number(self) -> str:
        start = self.pos
        if self._ch() == "0" and self._ch(1) in "xX":
            self._advance(2)
            while _is_hex(self._ch()):
                self._advance()
            return self.text[start:self.pos]
        seen_dot = False
        while _is_digit(self._ch()) or (self._ch() == "." and not seen_dot):
            if self._ch() == ".":
                seen_dot = True
            self._advance()
        if self._ch() in "eE":
            self._advance()
            if self._ch() in "+-":
                self._advance()
            while _is_digit(self._ch()):
                self._advance()
        return self.text[start:self.pos]

    def _read_string(self, quote: str) -> str:
        out = []
        self._advance()  # opening quote
        while self._ch() not in (quote, "\0"):
            ch = self._ch()
            if ch == "\\":
                self._advance()
                esc = self._ch()
                mapping = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                           '"': '"'}
                if esc == "\0":
                    break  # unterminated, tolerated like lexer.go:335
                out.append(mapping.get(esc, "\\" + esc))
                self._advance()
            else:
                out.append(ch)
                self._advance()
        if self._ch() == quote:
            self._advance()
        return "".join(out)

"""Tokenizer for the pipeline-config DSL.

Token inventory matches the reference grammar's terminals
(reference: src/config/config_grammar.lalrpop:7-81):

  IDENT    ``[a-zA-Z_][a-zA-Z0-9_-]*``  (identifiers may contain '-')
  INT      ``-?[0-9]+``                  (negatives: deliberate superset of the grammar)
  FLOAT    ``-?[0-9]+.[0-9]+``
  BOOL     ``true`` / ``false``
  ARROW    ``->``
  COLON, LBRACE, RBRACE, COMMA

``//`` line comments and ``/* ... */`` block comments are skipped anywhere
(the reference only admits comments between top-level expressions —
config_grammar.lalrpop:24-27 — we deliberately accept them anywhere, a strict
superset).  We likewise accept single-character identifiers, which the
reference's ``+``-quantified regex rejects (config_grammar.lalrpop:81), and we
split ``a->b`` into three tokens where maximal-munch lexing would mis-lex
``a-``; both are strict supersets of accepted inputs.

Errors are reported as ``LexError`` carrying the byte offset so the parser
can render the reference-style "Invalid token 'x' at line N: ..." diagnostic
(src/config/config.rs:107-113).
"""

from __future__ import annotations

import dataclasses
import enum


class TokKind(enum.Enum):
    IDENT = "identifier"
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    ARROW = "'->'"
    COLON = "':'"
    LBRACE = "'{'"
    RBRACE = "'}'"
    COMMA = "','"
    DOT = "'.'"
    EOF = "end of input"


@dataclasses.dataclass(frozen=True)
class Token:
    kind: TokKind
    text: str
    start: int  # byte offset into the source
    end: int


class LexError(Exception):
    def __init__(self, offset: int, char: str):
        super().__init__(f"invalid token {char!r} at offset {offset}")
        self.offset = offset
        self.char = char


def _is_ident_start(c: str) -> bool:
    return c.isascii() and (c.isalpha() or c == "_")


def _is_ident_char(c: str) -> bool:
    return c.isascii() and (c.isalnum() or c in "_-")


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        # Comments.
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = i
            while j < n and src[j] not in "\r\n":
                j += 1
            i = j
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                # Unterminated block comment: report the opening '/'.
                raise LexError(i, c)
            i = j + 2
            continue
        if c == "-" and i + 1 < n and src[i + 1] == ">":
            toks.append(Token(TokKind.ARROW, "->", i, i + 2))
            i += 2
            continue
        if c == ":":
            toks.append(Token(TokKind.COLON, ":", i, i + 1))
            i += 1
            continue
        if c == "{":
            toks.append(Token(TokKind.LBRACE, "{", i, i + 1))
            i += 1
            continue
        if c == "}":
            toks.append(Token(TokKind.RBRACE, "}", i, i + 1))
            i += 1
            continue
        if c == ",":
            toks.append(Token(TokKind.COMMA, ",", i, i + 1))
            i += 1
            continue
        if c == ".":
            toks.append(Token(TokKind.DOT, ".", i, i + 1))
            i += 1
            continue
        # Numbers: -?[0-9]+ (INT) and -?[0-9]+.[0-9]+ (FLOAT).
        if c.isdigit() or (c == "-" and i + 1 < n and src[i + 1].isdigit()):
            j = i + 1 if c == "-" else i
            while j < n and src[j].isdigit():
                j += 1
            if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
                j += 1
                while j < n and src[j].isdigit():
                    j += 1
                toks.append(Token(TokKind.FLOAT, src[i:j], i, j))
            else:
                # Deliberate superset of the reference grammar: it allows
                # negative FLOATS (-?[0-9]+\.[0-9]+) but not negative INTS
                # ([0-9]+, config_grammar.lalrpop:74-78) — almost certainly
                # an oversight, and "radius: -1" failing while
                # "radius: -1.0" parses is terrible UX.  Accepting the
                # negative int changes no currently-valid config.
                toks.append(Token(TokKind.INT, src[i:j], i, j))
            i = j
            continue
        if _is_ident_start(c):
            j = i + 1
            while j < n and _is_ident_char(src[j]):
                # Don't swallow the '-' of an arrow: "a->b" lexes as
                # IDENT("a"), ARROW, IDENT("b").
                if src[j] == "-" and j + 1 < n and src[j + 1] == ">":
                    break
                j += 1
            text = src[i:j]
            kind = TokKind.BOOL if text in ("true", "false") else TokKind.IDENT
            toks.append(Token(kind, text, i, j))
            i = j
            continue
        raise LexError(i, c)
    toks.append(Token(TokKind.EOF, "", n, n))
    return toks

"""Recursive-descent parser for the pipeline-config DSL.

Grammar (equivalent to reference src/config/config_grammar.lalrpop):

    file       := expr*
    expr       := pipeline_decl | graph_expr
    graph_expr := member ( '->' member )+          # at least one arrow
    member     := IDENT ( ':' IDENT )?
    pipeline_decl := IDENT ':' IDENT '{' params? '}'
    params     := param ( ',' param )*
    param      := IDENT ':' ( INT | FLOAT | BOOL )

Diagnostics mirror the reference's two shapes (src/config/config.rs:104-137):

    Invalid token 'x' at line N: before<RED>x<YELLOW>after
    Unrecognized token 'tok' at line N: before<RED>tok<YELLOW>after
    Expected to find: 'a', 'b', ...

rendered with the offending token highlighted red inside the yellow warning
line.  The parser raises ``ConfigParseError`` carrying the rendered message
lines; callers (semantics.parse) warnln them and keep the last-good config.
"""

from __future__ import annotations

from . import ast
from .lexer import LexError, TokKind, Token, tokenize
from ..utils import TERM_RED, TERM_YELLOW


class ConfigParseError(Exception):
    def __init__(self, messages: list[str]):
        super().__init__("\n".join(messages))
        self.messages = messages


def _line_of(src: str, offset: int) -> tuple[int, str, int]:
    """(line_number, line_contents, offset_in_line) for a byte offset.

    Same contract as the reference helper (src/config/config.rs:41-56).
    """
    line_number = 1
    for line in src.split("\n"):
        line_len = len(line) + 1
        if offset < line_len:
            return line_number, line, offset
        offset -= line_len
        line_number += 1
    return line_number, "", 0


def _invalid_token_message(src: str, offset: int, char: str) -> str:
    line_num, line, col = _line_of(src, offset)
    before = line[:col]
    after = line[col + 1 :]
    return (
        f"Invalid token '{char}' at line {line_num}: "
        f"{before}{TERM_RED}{char}{TERM_YELLOW}{after}"
    )


def _unrecognized_token_messages(src: str, tok: Token, expected: list[str]) -> list[str]:
    if tok.kind is TokKind.EOF:
        token_str = ""
        line_num, line, col = _line_of(src, max(0, tok.start - 1))
        before, after = line, ""
    else:
        token_str = src[tok.start : tok.end].rstrip("\n")
        line_num, line, col = _line_of(src, tok.start)
        line2_num, line2, col2 = _line_of(src, tok.end)
        before = line[:col]
        after = line2[col2:] if line_num == line2_num else ""
    expected_str = ", ".join(f"'{e}'" for e in expected)
    return [
        f"Unrecognized token '{token_str}' at line {line_num}: "
        f"{before}{TERM_RED}{token_str}{TERM_YELLOW}{after}",
        f"Expected to find: {expected_str}",
    ]


class _Parser:
    def __init__(self, src: str):
        self.src = src
        try:
            self.toks = tokenize(src)
        except LexError as e:
            raise ConfigParseError([_invalid_token_message(src, e.offset, e.char)]) from e
        self.pos = 0

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def advance(self) -> Token:
        tok = self.toks[self.pos]
        if tok.kind is not TokKind.EOF:
            self.pos += 1
        return tok

    def error(self, expected: list[str]) -> ConfigParseError:
        return ConfigParseError(
            _unrecognized_token_messages(self.src, self.peek(), expected)
        )

    def expect(self, kind: TokKind, expected_desc: str) -> Token:
        if self.peek().kind is not kind:
            raise self.error([expected_desc])
        return self.advance()

    # ---- grammar productions -------------------------------------------

    def parse_file(self) -> list[ast.Expr]:
        exprs: list[ast.Expr] = []
        while self.peek().kind is not TokKind.EOF:
            exprs.append(self.parse_expr())
        return exprs

    def parse_expr(self) -> ast.Expr:
        name = self.expect(TokKind.IDENT, "identifier")
        nxt = self.peek()
        if nxt.kind is TokKind.COLON:
            self.advance()
            second = self.expect(TokKind.IDENT, "identifier")
            after = self.peek()
            if after.kind is TokKind.LBRACE:
                return self.parse_pipeline_decl(name.text, second.text)
            if after.kind is TokKind.ARROW:
                first = ast.GraphMember(name.text, second.text)
                return self.parse_graph(first)
            raise self.error(["{", "->"])
        if nxt.kind is TokKind.ARROW:
            return self.parse_graph(ast.GraphMember(name.text, None))
        raise self.error([":", "->"])

    def parse_graph(self, first: ast.GraphMember) -> ast.GraphExpr:
        members = [first]
        # At least one arrow is required by the grammar
        # (config_grammar.lalrpop:30-37).
        self.expect(TokKind.ARROW, "->")
        members.append(self.parse_member())
        while self.peek().kind is TokKind.ARROW:
            self.advance()
            members.append(self.parse_member())
        return ast.GraphExpr(tuple(members))

    def parse_member(self) -> ast.GraphMember:
        name = self.expect(TokKind.IDENT, "identifier")
        if self.peek().kind is TokKind.COLON:
            # Lookahead: `a -> b : blur {` is a parse error in the reference
            # too (the '{' cannot follow a graph member).
            self.advance()
            desc = self.expect(TokKind.IDENT, "identifier")
            if self.peek().kind is TokKind.LBRACE:
                raise self.error(["->"])
            return ast.GraphMember(name.text, desc.text)
        return ast.GraphMember(name.text, None)

    def parse_pipeline_decl(self, name: str, pipeline_type: str) -> ast.PipelineDecl:
        self.expect(TokKind.LBRACE, "{")
        params: dict[str, ast.ParamValue] = {}
        if self.peek().kind is TokKind.RBRACE:
            self.advance()
            return ast.PipelineDecl(name, pipeline_type, params)
        key, value = self.parse_param()
        params[key] = value
        while self.peek().kind is TokKind.COMMA:
            self.advance()
            key, value = self.parse_param()
            params[key] = value
        self.expect(TokKind.RBRACE, "}")
        return ast.PipelineDecl(name, pipeline_type, params)

    def parse_param(self) -> tuple[str, ast.ParamValue]:
        key_tok = self.expect(TokKind.IDENT, "identifier")
        key = key_tok.text
        # Dotted keys address nested UBO struct members ("outer.inner").
        while self.peek().kind is TokKind.DOT:
            self.advance()
            key += "." + self.expect(TokKind.IDENT, "identifier").text
        self.expect(TokKind.COLON, ":")
        tok = self.peek()
        if tok.kind is TokKind.INT:
            self.advance()
            return key, ast.ParamValue(tok.text, int(tok.text))
        if tok.kind is TokKind.FLOAT:
            self.advance()
            return key, ast.ParamValue(tok.text, float(tok.text))
        if tok.kind is TokKind.BOOL:
            self.advance()
            return key, ast.ParamValue(tok.text, tok.text == "true")
        raise self.error(["int", "float", "bool"])


def parse_exprs(src: str) -> list[ast.Expr]:
    """Parse a config source string into AST expressions.

    Raises ConfigParseError with reference-style diagnostics on bad input.
    """
    return _Parser(src).parse_file()

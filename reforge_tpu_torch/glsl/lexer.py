"""GLSL tokenizer.

Covers the GLSL 4.5 compute-shader subset used by image filters: the same
source language the reference compiles with shaderc at runtime
(reference: src/vulkan/shader.rs:73-93).  Supports ``//`` and ``/* */``
comments, ``#version``/``#extension`` directives (ignored), object-like
``#define`` macros (token-level substitution) with ``#undef``, and
conditional compilation: ``#ifdef``/``#ifndef``/``#if``/``#elif``/
``#else``/``#endif`` with C integer constant expressions (``defined``,
arithmetic/shift/comparison/logical operators) plus ``#error``.
Inactive lines are blanked, preserving diagnostic line numbers.
"""

from __future__ import annotations

import dataclasses
import re

_HEX_RE = re.compile(r"0[xX][0-9a-fA-F]+[uU]?")
# Floats need a '.', an exponent, or an f/F suffix to be floats.
_FLOAT_RE = re.compile(r"(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?[fF]?|\d+(?:[eE][+-]?\d+)[fF]?|\d+[fF]")
_INT_RE = re.compile(r"\d+[uU]?")


class GlslError(Exception):
    """Compile error with line info, printed like shaderc diagnostics."""

    def __init__(self, msg: str, line: int | None = None):
        self.line = line
        self.msg = msg
        super().__init__(f"line {line}: {msg}" if line else msg)


@dataclasses.dataclass(frozen=True)
class Tok:
    kind: str  # 'id' | 'int' | 'float' | 'op' | 'eof'
    text: str
    line: int


KEYWORDS = {
    "void", "float", "int", "uint", "bool", "double",
    "vec2", "vec3", "vec4", "ivec2", "ivec3", "ivec4",
    "uvec2", "uvec3", "uvec4", "bvec2", "bvec3", "bvec4",
    "mat2", "mat3", "mat4",
    "if", "else", "for", "while", "do", "return", "break", "continue",
    "true", "false", "const", "in", "out", "inout", "uniform", "buffer",
    "layout", "readonly", "writeonly", "coherent", "volatile", "restrict",
    "image2D", "sampler2D", "struct", "discard", "precision", "highp",
    "mediump", "lowp", "shared",
}

# Multi-char operators, longest first.
_OPS3 = ["<<=", ">>=", "..."]
_OPS2 = [
    "==", "!=", "<=", ">=", "&&", "||", "++", "--", "+=", "-=", "*=", "/=",
    "%=", "&=", "|=", "^=", "<<", ">>",
]


_PP_DEFINED_RE = re.compile(r"defined\s*(?:\(\s*(\w+)\s*\)|(\w+))")
_PP_ID_RE = re.compile(r"\b[A-Za-z_]\w*\b")
_PP_SUFFIX_RE = re.compile(r"\b(\d+|0[xX][0-9a-fA-F]+)[uUlL]+\b")
_PP_OCTAL_RE = re.compile(r"\b0([0-7]+)\b")
_PP_SAFE_RE = re.compile(r"^[\s0-9()+\-*/%<>=!&|^~]*$")


def _pp_eval(expr: str, macros: dict[str, str], line: int,
             fnames=frozenset()) -> int:
    """Evaluate a preprocessor ``#if``/``#elif`` integer expression.

    C semantics on the subset real shaders use: ``defined(X)``, macro
    substitution (undefined identifiers are 0), integer/hex/octal
    literals with u/l suffixes, arithmetic, shifts, comparisons, bitwise
    and logical operators.  The sanitized expression is evaluated in a
    bare namespace; anything outside the subset is rejected with a
    diagnostic rather than mis-evaluated."""
    def is_def(m):
        nm = m.group(1) or m.group(2)
        return "1" if (nm in macros or nm in fnames) else "0"

    e = _PP_DEFINED_RE.sub(is_def, expr)
    for _ in range(16):  # expand object-like macros to fixpoint
        e2 = _PP_ID_RE.sub(lambda m: macros.get(m.group(0), m.group(0)), e)
        e2 = _PP_DEFINED_RE.sub(is_def, e2)
        if e2 == e:
            break
        e = e2
    e = _PP_SUFFIX_RE.sub(r"\1", e)
    e = re.sub(
        r"\b0[xX][0-9a-fA-F]+\b", lambda m: str(int(m.group(0), 16)), e
    )
    e = _PP_ID_RE.sub("0", e)  # remaining identifiers are undefined -> 0
    e = _PP_OCTAL_RE.sub(lambda m: str(int(m.group(1), 8)), e)
    if not _PP_SAFE_RE.match(e):
        raise GlslError(f"unsupported preprocessor expression: {expr}", line)
    # C -> python spellings (order matters: protect != before rewriting !).
    e = e.replace("!=", "\0")
    e = e.replace("&&", " and ").replace("||", " or ").replace("!", " not ")
    e = e.replace("\0", "!=")
    # C integer division truncates toward zero; python's // floors.
    # Preprocessor conditions with negative division are vanishingly
    # rare, so floor division is an accepted approximation here.
    e = re.sub(r"(?<![/*])/(?![/*])", "//", e)
    try:
        v = eval(e, {"__builtins__": {}}, {})  # sanitized above
    except Exception:
        raise GlslError(
            f"unsupported preprocessor expression: {expr}", line
        ) from None
    return int(bool(v)) if isinstance(v, bool) else int(v)


def tokenize(src: str) -> list[Tok]:
    # Pass 1: strip comments, run the preprocessor (macros, conditionals).
    macros: dict[str, str] = {}
    # Function-like macros: name -> (params, body).  Expanded at token
    # level with single-pass parameter substitution (no # / ## operators
    # — GLSL has no strings to stringize).
    fmacros: dict[str, tuple[list[str], str]] = {}
    # Conditional stack entries: [branch_active, any_branch_taken, saw_else].
    cond_stack: list[list[bool]] = []
    lines_out: list[str] = []
    i = 0
    n = len(src)
    in_block_comment = False
    # Backslash line continuations splice BEFORE comment/directive
    # processing (the C phase order), attributing the merged text to the
    # first physical line and blanking the absorbed ones so diagnostic
    # line numbers stay true.
    raw_lines = src.split("\n")
    spliced: list[str] = []
    li = 0
    while li < len(raw_lines):
        cur = raw_lines[li]
        absorbed = 0
        while cur.rstrip().endswith("\\") and li + absorbed + 1 < len(raw_lines):
            cur = cur.rstrip()[:-1] + " " + raw_lines[li + absorbed + 1]
            absorbed += 1
        spliced.append(cur)
        spliced.extend([""] * absorbed)
        li += absorbed + 1
    for lineno, raw in enumerate(spliced, start=1):
        line = raw
        if in_block_comment:
            end = line.find("*/")
            if end < 0:
                lines_out.append("")
                continue
            line = " " * (end + 2) + line[end + 2 :]
            in_block_comment = False
        # Strip comments on this line (handling // and /* */ pairs).
        out = []
        j = 0
        while j < len(line):
            if line.startswith("//", j):
                break
            if line.startswith("/*", j):
                end = line.find("*/", j + 2)
                if end < 0:
                    in_block_comment = True
                    break
                j = end + 2
                out.append(" ")
                continue
            out.append(line[j])
            j += 1
        clean = "".join(out)
        stripped = clean.strip()
        if stripped.startswith("#"):
            parts = stripped[1:].split(None, 2)
            directive = parts[0] if parts else ""
            outer = all(c[0] for c in cond_stack[:-1])
            here = all(c[0] for c in cond_stack)
            if directive in ("ifdef", "ifndef"):
                if len(parts) < 2:
                    raise GlslError(f"#{directive} needs a name", lineno)
                t = ((parts[1] in macros or parts[1] in fmacros)
                     == (directive == "ifdef"))
                cond_stack.append([here and t, t or not here, False])
            elif directive == "if":
                expr = stripped[1:].split(None, 1)[1] if len(parts) > 1 else ""
                t = (bool(_pp_eval(expr, macros, lineno, fmacros.keys()))
                     if here else False)
                cond_stack.append([t, t or not here, False])
            elif directive == "elif":
                if not cond_stack or cond_stack[-1][2]:
                    raise GlslError("#elif without matching #if", lineno)
                top = cond_stack[-1]
                expr = stripped[1:].split(None, 1)[1] if len(parts) > 1 else ""
                t = (outer and not top[1]
                     and bool(_pp_eval(expr, macros, lineno,
                                       fmacros.keys())))
                top[0] = t
                top[1] = top[1] or t
            elif directive == "else":
                if not cond_stack or cond_stack[-1][2]:
                    raise GlslError("#else without matching #if", lineno)
                top = cond_stack[-1]
                top[0] = outer and not top[1]
                top[1] = True
                top[2] = True
            elif directive == "endif":
                if not cond_stack:
                    raise GlslError("#endif without matching #if", lineno)
                cond_stack.pop()
            elif not here:
                pass  # other directives in inactive regions are skipped
            elif directive == "define":
                rest = stripped[1:].split(None, 1)[1] if len(parts) > 1 else ""
                mo = re.match(r"([A-Za-z_]\w*)", rest)
                if not mo:
                    raise GlslError("#define needs a macro name", lineno)
                nm = mo.group(1)
                after = rest[mo.end():]
                if after.startswith("("):
                    # Function-like: '(' must touch the name (C rule).
                    close = after.find(")")
                    if close < 0:
                        raise GlslError(
                            "unterminated macro parameter list", lineno
                        )
                    pl = [p.strip() for p in after[1:close].split(",")
                          if p.strip()]
                    fmacros[nm] = (pl, after[close + 1:].strip())
                else:
                    macros[nm] = after.strip()
            elif directive == "undef":
                if len(parts) >= 2:
                    macros.pop(parts[1], None)
                    fmacros.pop(parts[1], None)
            elif directive == "error":
                msg = stripped[1:].split(None, 1)[1] if len(parts) > 1 else ""
                raise GlslError(f"#error {msg}", lineno)
            lines_out.append("")
        elif cond_stack and not all(c[0] for c in cond_stack):
            lines_out.append("")  # inactive branch: blank, keep line count
        else:
            lines_out.append(clean)
    if cond_stack:
        raise GlslError("unterminated #if/#ifdef block", len(src.split("\n")))

    toks: list[Tok] = []
    depth = [0]  # macro expansion depth (recursive macros are an error)

    def _macro_args(text: str, k: int, line: int) -> tuple[list[str], int]:
        """Parse '(a, f(b, c), d)' starting at the '('; returns
        (top-level-comma-split args, index past the ')')."""
        assert text[k] == "("
        d = 0
        args: list[str] = []
        cur: list[str] = []
        j = k
        while j < len(text):
            c = text[j]
            if c == "(":
                d += 1
                if d > 1:
                    cur.append(c)
            elif c == ")":
                d -= 1
                if d == 0:
                    args.append("".join(cur).strip())
                    return args, j + 1
                cur.append(c)
            elif c == "," and d == 1:
                args.append("".join(cur).strip())
                cur = []
            else:
                cur.append(c)
            j += 1
        raise GlslError(
            "macro arguments must close on the same line", line
        )

    def emit_text(text: str, line: int) -> None:
        """Tokenize a chunk (used for macro bodies too)."""
        k = 0
        m = len(text)
        while k < m:
            c = text[k]
            if c in " \t\r":
                k += 1
                continue
            if c.isdigit() or (c == "." and k + 1 < m and text[k + 1].isdigit()):
                mo = _HEX_RE.match(text, k)
                if mo:
                    toks.append(Tok("int", mo.group(0), line))
                    k = mo.end()
                    continue
                mo = _FLOAT_RE.match(text, k)
                if mo:
                    toks.append(Tok("float", mo.group(0), line))
                    k = mo.end()
                    continue
                mo = _INT_RE.match(text, k)
                assert mo is not None
                toks.append(Tok("int", mo.group(0), line))
                k = mo.end()
                continue
            if c.isalpha() or c == "_":
                j = k
                while j < m and (text[j].isalnum() or text[j] == "_"):
                    j += 1
                word = text[k:j]
                if word in fmacros:
                    jj = j
                    while jj < m and text[jj] in " \t":
                        jj += 1
                    if jj < m and text[jj] == "(":
                        args, end = _macro_args(text, jj, line)
                        params, body = fmacros[word]
                        if args == [""] and not params:
                            args = []
                        if len(args) != len(params):
                            raise GlslError(
                                f"macro {word} expects {len(params)} "
                                f"argument(s), got {len(args)}", line
                            )
                        if params:
                            # Single pass over all parameters at once so
                            # an argument's text is never re-scanned for
                            # other parameter names.
                            amap = dict(zip(params, args))
                            pat = re.compile(
                                r"\b(?:"
                                + "|".join(map(re.escape, params)) + r")\b"
                            )
                            body = pat.sub(lambda mo: amap[mo.group(0)], body)
                        depth[0] += 1
                        if depth[0] > 64:
                            raise GlslError(
                                f"recursive macro expansion: {word}", line
                            )
                        emit_text(body, line)
                        depth[0] -= 1
                        k = end
                        continue
                if word == "__LINE__":
                    toks.append(Tok("int", str(line), line))
                    k = j
                    continue
                if word == "__VERSION__":
                    toks.append(Tok("int", "450", line))
                    k = j
                    continue
                if word == "__FILE__":
                    toks.append(Tok("int", "0", line))
                    k = j
                    continue
                if word in macros and macros[word] != "":
                    depth[0] += 1
                    if depth[0] > 64:
                        raise GlslError(
                            f"recursive macro expansion: {word}", line
                        )
                    emit_text(macros[word], line)
                    depth[0] -= 1
                else:
                    toks.append(Tok("id", word, line))
                k = j
                continue
            matched = False
            for op in _OPS3 + _OPS2:
                if text.startswith(op, k):
                    toks.append(Tok("op", op, line))
                    k += len(op)
                    matched = True
                    break
            if matched:
                continue
            if c in "+-*/%<>=!&|^~?:;,.(){}[]":
                toks.append(Tok("op", c, line))
                k += 1
                continue
            raise GlslError(f"unexpected character {c!r}", line)

    for lineno, line in enumerate(lines_out, start=1):
        emit_text(line, lineno)

    toks.append(Tok("eof", "", len(lines_out)))
    return toks

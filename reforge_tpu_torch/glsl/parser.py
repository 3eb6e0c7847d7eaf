"""GLSL recursive-descent parser producing the ast.Shader structure.

Parses the compute-shader subset: layout-qualified image/UBO/SSBO
declarations (the binding surface the reference discovers via SPIR-V
reflection — src/vulkan/shader.rs:106-160), const globals, functions, and
the full C-like statement/expression grammar.
"""

from __future__ import annotations


from . import ast
from .lexer import GlslError, Tok, tokenize

TYPE_NAMES = {
    "void", "float", "int", "uint", "bool",
    "vec2", "vec3", "vec4", "ivec2", "ivec3", "ivec4",
    "uvec2", "uvec3", "uvec4", "bvec2", "bvec3", "bvec4",
    "mat2", "mat3", "mat4",
}

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>="}

# Binary operator precedence, higher binds tighter.
_BIN_PREC = {
    "||": 1,
    "&&": 2,
    "|": 3,
    "^": 4,
    "&": 5,
    "==": 6, "!=": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}


class Parser:
    def __init__(self, src: str, stage: str = "compute"):
        self.toks = tokenize(src)
        self.pos = 0
        self.stage = stage
        self.frag_outputs: list[str] = []
        self.frag_inputs: list[tuple[str, str]] = []

    # ---- token helpers --------------------------------------------------

    def peek(self, ahead: int = 0) -> Tok:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, text: str) -> bool:
        return self.peek().text == text and self.peek().kind in ("op", "id")

    def accept(self, text: str) -> bool:
        if self.at(text):
            self.next()
            return True
        return False

    def expect(self, text: str) -> Tok:
        t = self.peek()
        if t.text != text:
            raise GlslError(f"expected '{text}', found '{t.text or '<eof>'}'", t.line)
        return self.next()

    def expect_ident(self) -> Tok:
        t = self.peek()
        if t.kind != "id":
            raise GlslError(f"expected identifier, found '{t.text or '<eof>'}'", t.line)
        return self.next()

    # ---- top level ------------------------------------------------------

    def parse_shader(self) -> ast.Shader:
        local_size = (1, 1, 1)
        images: list[ast.ImageDecl] = []
        ubos: list[ast.UboDecl] = []
        ssbos: list[ast.SsboDecl] = []
        globals_: list[ast.Decl] = []
        shared: list[tuple] = []
        functions: dict[str, ast.FuncDecl] = {}
        self.structs: dict[str, list] = {}  # name -> [(type, field), ...]

        while self.peek().kind != "eof":
            t = self.peek()
            if t.text == "layout":
                result = self.parse_layout_decl()
                if isinstance(result, tuple):
                    local_size = result
                elif isinstance(result, ast.ImageDecl):
                    images.append(result)
                elif isinstance(result, ast.UboDecl):
                    ubos.append(result)
                elif isinstance(result, ast.SsboDecl):
                    ssbos.append(result)
                elif isinstance(result, ast.Decl):
                    globals_.append(result)  # specialization constant
                continue
            if t.text == "precision":
                while not self.accept(";"):
                    self.next()
                continue
            if t.text == "shared":
                shared.append(self.parse_shared_decl())
                continue
            if t.text in ("in", "out"):
                self.parse_stage_io(t.text)
                continue
            if t.text == "struct":
                self.parse_struct_decl()
                continue
            # const global / global var / function
            is_const = self.accept("const")
            type_tok = self.expect_ident()
            if type_tok.text not in TYPE_NAMES and type_tok.text not in self.structs:
                raise GlslError(f"unknown type '{type_tok.text}'", type_tok.line)
            # Array return type: `float[4] f(...)`.
            ret_array = None
            if self.at("["):
                self.next()
                size_tok = self.next()
                try:
                    ret_array = int(size_tok.text)
                except ValueError:
                    raise GlslError(
                        "array return size must be a literal", size_tok.line
                    )
                self.expect("]")
            name_tok = self.expect_ident()
            if self.at("(") and not is_const:
                rt = (
                    type_tok.text if ret_array is None
                    else f"{type_tok.text}[{ret_array}]"
                )
                functions[name_tok.text] = self.parse_function(
                    rt, name_tok.text
                )
            else:
                if ret_array is not None:
                    raise GlslError(
                        "array-typed globals use `T name[N]` syntax",
                        name_tok.line,
                    )
                decl = self.finish_var_decl(type_tok.text, name_tok.text, is_const)
                globals_.append(decl)
        if "main" not in functions:
            raise GlslError("shader has no main() function")
        return ast.Shader(
            local_size, images, ubos, ssbos, globals_, functions,
            stage=self.stage,
            frag_outputs=self.frag_outputs,
            frag_inputs=self.frag_inputs,
            structs=dict(self.structs),
            shared=shared,
        )

    def parse_shared_decl(self) -> tuple:
        """``shared <scalar-type> name[SIZE];`` — a workgroup-shared array."""
        t = self.expect("shared")
        type_tok = self.expect_ident()
        if type_tok.text not in ("float", "int", "uint"):
            raise GlslError(
                f"shared arrays must be float/int/uint (got {type_tok.text})",
                type_tok.line,
            )
        name_tok = self.expect_ident()
        self.expect("[")
        size_tok = self.next()
        if size_tok.kind != "int":
            raise GlslError("shared array size must be a literal", size_tok.line)
        self.expect("]")
        self.expect(";")
        size = int(size_tok.text.rstrip("uU"))
        if size <= 0:
            raise GlslError("shared array size must be positive", size_tok.line)
        return (type_tok.text, name_tok.text, size, t.line)

    def parse_struct_decl(self) -> None:
        """struct Name { type field; ... };"""
        self.expect("struct")
        name = self.expect_ident().text
        self.expect("{")
        fields: list[tuple[str, str]] = []
        while not self.accept("}"):
            ftype = self.expect_ident().text
            if ftype not in TYPE_NAMES and ftype not in self.structs:
                raise GlslError(f"unknown type '{ftype}' in struct", self.peek().line)
            fname = self.expect_ident().text
            if self.accept("["):
                # Array member: sized by an integer literal (the GLSL
                # constant-expression subset the type string can carry);
                # encoded as "elem[n]", which convert()/_zero_of already
                # understand (array return types use the same encoding).
                t = self.peek()
                if t.kind != "int":
                    raise GlslError(
                        "struct array member size must be an integer "
                        "literal", t.line,
                    )
                self.next()
                self.expect("]")
                ftype = f"{ftype}[{int(t.text.rstrip('uU'), 0)}]"
            self.expect(";")
            fields.append((ftype, fname))
        self.expect(";")
        self.structs[name] = fields

    def parse_stage_io(self, direction: str) -> None:
        """Top-level `in type name;` / `out type name;` interface variables
        (fragment stage)."""
        tok = self.next()  # 'in' | 'out'
        type_tok = self.expect_ident()
        if type_tok.text not in TYPE_NAMES:
            raise GlslError(f"unknown type '{type_tok.text}'", type_tok.line)
        name = self.expect_ident().text
        self.expect(";")
        if direction == "out":
            if type_tok.text != "vec4":
                raise GlslError("fragment outputs must be vec4", tok.line)
            self.frag_outputs.append(name)
        else:
            self.frag_inputs.append((type_tok.text, name))

    def parse_layout_qualifier(self) -> dict:
        self.expect("layout")
        self.expect("(")
        items: dict = {}
        while True:
            key = self.expect_ident().text
            if self.accept("="):
                val_tok = self.next()
                try:
                    items[key] = int(val_tok.text, 0)
                except ValueError:
                    items[key] = val_tok.text
            else:
                items[key] = None
            if not self.accept(","):
                break
        self.expect(")")
        return items

    def parse_layout_decl(self):
        items = self.parse_layout_qualifier()

        # layout(constant_id = N) const TYPE NAME = literal;
        # Specialization constant: shaderc compiles these and the reference
        # never passes VkSpecializationInfo (pipeline.rs:44-88), so the
        # default initializer is the value.  Parsed as a const global whose
        # spec_id marks it config-settable (reflected as a parameter).
        if "constant_id" in items:
            t = self.peek()
            if not self.accept("const"):
                raise GlslError(
                    "layout(constant_id=N) must declare a 'const' scalar",
                    t.line,
                )
            type_tok = self.expect_ident()
            if type_tok.text not in ("int", "uint", "float", "bool"):
                raise GlslError(
                    f"specialization constants must be scalar int/uint/"
                    f"float/bool (got '{type_tok.text}')",
                    type_tok.line,
                )
            name_tok = self.expect_ident()
            decl = self.finish_var_decl(type_tok.text, name_tok.text, True)
            if not isinstance(decl, ast.Decl):
                raise GlslError(
                    "one specialization constant per layout(constant_id=N) "
                    "declaration",
                    name_tok.line,
                )
            if decl.init is None:
                raise GlslError(
                    f"specialization constant '{name_tok.text}' needs a "
                    f"default initializer",
                    name_tok.line,
                )
            decl.spec_id = int(items["constant_id"])
            return decl

        # layout(local_size_x = N, ...) in;  — or a layout-qualified
        # interface variable: layout(location=0) in/out TYPE NAME;
        if self.at("in") and self.peek(1).text == ";":
            self.next()
            self.next()
            return (
                int(items.get("local_size_x", 1)),
                int(items.get("local_size_y", 1)),
                int(items.get("local_size_z", 1)),
            )
        if self.at("in") or self.at("out"):
            self.parse_stage_io(self.peek().text)
            return None

        quals = set()
        while self.peek().text in (
            "readonly", "writeonly", "coherent", "volatile", "restrict",
            "uniform", "buffer", "highp", "mediump", "lowp",
        ):
            quals.add(self.next().text)

        t = self.peek()
        if t.text in ("image2D", "sampler2D"):
            sampled = t.text == "sampler2D"
            self.next()
            name = self.expect_ident().text
            self.expect(";")
            fmt = next(
                (k for k in items if k in (
                    "rgba8", "rgba16f", "rgba32f", "r32f", "rg32f", "r8",
                    "rgba8_snorm",
                )),
                None,
            )
            if "binding" not in items:
                raise GlslError(f"image '{name}' has no binding", t.line)
            return ast.ImageDecl(
                name=name,
                binding=int(items["binding"]),
                format=fmt,
                readonly="readonly" in quals or sampled,
                writeonly="writeonly" in quals,
                sampled=sampled,
                line=t.line,
            )

        # uniform/buffer block
        block_name = self.expect_ident().text
        self.expect("{")
        members: list[ast.UboMember] = []
        while not self.accept("}"):
            mtype = self.expect_ident().text
            if mtype not in TYPE_NAMES and mtype not in getattr(self, "structs", {}):
                raise GlslError(f"unknown type '{mtype}' in block", self.peek().line)
            mname = self.expect_ident().text
            array_size = None
            runtime = False
            if self.accept("["):
                # `float data[];` — runtime-sized trailing array (std430):
                # size resolves from the allocated buffer (interp.py).
                if not self.at("]"):
                    array_size = int(self.next().text)
                else:
                    runtime = True
                self.expect("]")
            self.expect(";")
            members.append(ast.UboMember(mtype, mname, array_size, runtime))
        instance = None
        if self.peek().kind == "id":
            instance = self.next().text
        self.expect(";")
        binding = int(items.get("binding", 0))
        if "buffer" in quals:
            return ast.SsboDecl(
                block_name, binding, members, instance,
                readonly="readonly" in quals, writeonly="writeonly" in quals,
                line=t.line,
            )
        return ast.UboDecl(block_name, binding, members, instance, line=t.line)

    def parse_function(self, return_type: str, name: str) -> ast.FuncDecl:
        line = self.peek().line
        self.expect("(")
        params: list[ast.Param] = []
        if not self.at(")"):
            while True:
                qual = "in"
                while self.peek().text in ("in", "out", "inout", "const"):
                    q = self.next().text
                    if q in ("in", "out", "inout"):
                        qual = q
                ptype = self.expect_ident().text
                if ptype == "void" and self.at(")"):
                    break
                pname = self.expect_ident().text
                asize = None
                if self.accept("["):
                    asize = int(self.next().text)
                    self.expect("]")
                params.append(ast.Param(ptype, pname, qual, asize))
                if not self.accept(","):
                    break
        self.expect(")")
        body = self.parse_block()
        return ast.FuncDecl(return_type, name, params, body, line)

    def finish_var_decl(self, type_name: str, var_name: str, is_const: bool):
        """Parse the remainder of `type name ...;`: array suffix, init,
        and further comma-separated declarators (`float a = 1.0, b;`).
        Returns one ast.Decl, or an ast.DeclList for multi-declarator
        statements (executed in order in the current scope)."""
        line = self.peek().line
        decls = []
        name = var_name
        while True:
            array_size = None
            if self.accept("["):
                if not self.at("]"):
                    array_size = self.parse_expr()
                self.expect("]")
                if self.at("["):
                    raise GlslError(
                        "arrays of arrays are not supported (use a "
                        "flattened 1-D array)", self.peek().line,
                    )
            init = None
            if self.accept("="):
                init = self.parse_expr()
            decls.append(
                ast.Decl(type_name, name, init, array_size, is_const, line)
            )
            if not self.accept(","):
                break
            name = self.expect_ident().text
        self.expect(";")
        return decls[0] if len(decls) == 1 else ast.DeclList(decls, line)

    # ---- statements -----------------------------------------------------

    def parse_block(self) -> list:
        self.expect("{")
        body = []
        while not self.accept("}"):
            body.append(self.parse_stmt())
        return body

    def parse_stmt(self):
        t = self.peek()
        if t.text == "{":
            return ast.Block(self.parse_block(), t.line)
        if t.text == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt_as_list()
            other = None
            if self.accept("else"):
                other = self.parse_stmt_as_list()
            return ast.If(cond, then, other, t.line)
        if t.text == "for":
            self.next()
            self.expect("(")
            init = None
            if not self.at(";"):
                init = self.parse_simple_stmt()
            else:
                self.next()
            cond = None
            if not self.at(";"):
                cond = self.parse_expr()
            self.expect(";")
            update = None
            if not self.at(")"):
                update = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt_as_list()
            return ast.For(init, cond, update, body, t.line)
        if t.text == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt_as_list()
            return ast.While(cond, body, t.line)
        if t.text == "do":
            self.next()
            body = self.parse_stmt_as_list()
            self.expect("while")
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return ast.DoWhile(cond, body, t.line)
        if t.text == "switch":
            self.next()
            self.expect("(")
            selector = self.parse_expr()
            self.expect(")")
            self.expect("{")
            cases: list = []
            current_values: list = []
            current_body: list = []

            def flush():
                if current_values or current_body:
                    cases.append((list(current_values), list(current_body)))
                    current_values.clear()
                    current_body.clear()

            while not self.accept("}"):
                if self.at("case"):
                    if current_body:
                        flush()
                    self.next()
                    val = self.parse_expr()
                    self.expect(":")
                    current_values.append(val)
                elif self.at("default"):
                    if current_body:
                        flush()
                    self.next()
                    self.expect(":")
                    current_values.append(None)
                else:
                    current_body.append(self.parse_stmt())
            flush()
            return ast.Switch(selector, cases, t.line)
        if t.text == "return":
            self.next()
            value = None
            if not self.at(";"):
                value = self.parse_expr()
            self.expect(";")
            return ast.Return(value, t.line)
        if t.text == "break":
            self.next()
            self.expect(";")
            return ast.Break(t.line)
        if t.text == "continue":
            self.next()
            self.expect(";")
            return ast.Continue(t.line)
        if t.text == "discard":
            self.next()
            self.expect(";")
            return ast.Discard(t.line)
        return self.parse_simple_stmt()

    def parse_stmt_as_list(self) -> list:
        s = self.parse_stmt()
        return s.body if isinstance(s, ast.Block) else [s]

    def parse_simple_stmt(self):
        """Declaration or expression statement, consuming the ';'."""
        t = self.peek()
        is_const = False
        if t.text == "const":
            is_const = True
            self.next()
            t = self.peek()
        if (
            t.kind == "id"
            and (t.text in TYPE_NAMES or t.text in getattr(self, "structs", {}))
            and self.peek(1).kind == "id"
        ):
            self.next()
            name = self.expect_ident().text
            return self.finish_var_decl(t.text, name, is_const)
        expr = self.parse_expr()
        self.expect(";")
        return ast.ExprStmt(expr, t.line)

    # ---- expressions ----------------------------------------------------

    def parse_expr(self):
        return self.parse_assignment()

    def parse_assignment(self):
        left = self.parse_ternary()
        t = self.peek()
        if t.kind == "op" and t.text in _ASSIGN_OPS:
            self.next()
            value = self.parse_assignment()
            return ast.Assign(t.text, left, value, t.line)
        return left

    def parse_ternary(self):
        cond = self.parse_binary(0)
        if self.at("?"):
            line = self.next().line
            then = self.parse_assignment()
            self.expect(":")
            other = self.parse_assignment()
            return ast.Ternary(cond, then, other, line)
        return cond

    def parse_binary(self, min_prec: int):
        left = self.parse_unary()
        while True:
            t = self.peek()
            prec = _BIN_PREC.get(t.text) if t.kind == "op" else None
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.parse_binary(prec + 1)
            left = ast.Binary(t.text, left, right, t.line)

    def parse_unary(self):
        t = self.peek()
        if t.kind == "op" and t.text in ("-", "!", "~", "+"):
            self.next()
            expr = self.parse_unary()
            if t.text == "+":
                return expr
            return ast.Unary(t.text, expr, t.line)
        if t.kind == "op" and t.text in ("++", "--"):
            self.next()
            expr = self.parse_unary()
            return ast.Unary(t.text + "pre", expr, t.line)
        return self.parse_postfix()

    def parse_postfix(self):
        expr = self.parse_primary()
        while True:
            t = self.peek()
            if t.text == ".":
                self.next()
                name = self.expect_ident().text
                if self.peek().text == "(":
                    # Method-call syntax; GLSL only defines .length().
                    if name != "length":
                        raise GlslError(f"unknown method '.{name}()'", t.line)
                    self.next()
                    self.expect(")")
                    expr = ast.Call("__method_length", [expr], t.line)
                else:
                    expr = ast.Member(expr, name, t.line)
            elif t.text == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                expr = ast.Index(expr, idx, t.line)
            elif t.text in ("++", "--") and t.kind == "op":
                self.next()
                expr = ast.Unary(t.text + "post", expr, t.line)
            else:
                return expr

    def parse_primary(self):
        t = self.peek()
        if t.kind == "int":
            self.next()
            text = t.text.rstrip("uU")
            try:
                if text.lower().startswith("0x"):
                    value = int(text, 16)
                elif len(text) > 1 and text.startswith("0"):
                    # GLSL/C leading-zero literals are octal.
                    value = int(text, 8)
                else:
                    value = int(text, 10)
            except ValueError:
                raise GlslError(f"invalid integer literal '{t.text}'", t.line)
            return ast.Num(value, False, t.line,
                           is_uint=t.text[-1] in "uU")
        if t.kind == "float":
            self.next()
            return ast.Num(float(t.text.rstrip("fF")), True, t.line)
        if t.text == "(":
            self.next()
            expr = self.parse_expr()
            self.expect(")")
            return expr
        if t.kind == "id":
            if t.text == "true":
                self.next()
                return ast.BoolLit(True, t.line)
            if t.text == "false":
                self.next()
                return ast.BoolLit(False, t.line)
            self.next()
            # Array constructor: float[5](...) or float[](...)
            if t.text in TYPE_NAMES and self.at("["):
                self.next()
                size = None
                if not self.at("]"):
                    size_tok = self.next()
                    size = int(size_tok.text)
                self.expect("]")
                self.expect("(")
                elems = []
                if not self.at(")"):
                    while True:
                        elems.append(self.parse_assignment())
                        if not self.accept(","):
                            break
                self.expect(")")
                return ast.ArrayLit(t.text, size, elems, t.line)
            if self.at("("):
                self.next()
                args = []
                if not self.at(")"):
                    while True:
                        args.append(self.parse_assignment())
                        if not self.accept(","):
                            break
                self.expect(")")
                return ast.Call(t.text, args, t.line)
            return ast.Ident(t.text, t.line)
        raise GlslError(f"unexpected token '{t.text or '<eof>'}'", t.line)


def parse_shader_source(src: str, stage: str = "compute") -> ast.Shader:
    return Parser(src, stage=stage).parse_shader()

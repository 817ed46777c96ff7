"""Frozen copy of rene_tpu_torch/pbrt/parser.py at commit ed2dcef.

pbrt-v3 scene file parser.

A hand-written tokenizer + recursive-descent parser covering the same grammar
as the reference's chumsky combinators (pbrt-parser/src/lib.rs):

* comments (`# ...`), whitespace
* floats (``1``, ``2.25``, ``1e5``, ``.9``), integers, quoted strings with
  escapes, bools (``"true"``/``"false"``)
* bracketed lists, typed arguments (``"float fov" 45``, ``"rgb Kd" [...]``)
* pre-world directives: LookAt/Rotate/Scale/Translate/Transform/
  ConcatTransform, Camera/Sampler/Integrator/PixelFilter/Film
* world block: Texture, NamedMaterial, LightSource, AreaLightSource, Material,
  MakeNamedMaterial, MakeNamedMedium, Shape, ObjectInstance,
  CoordSysTransform, MediumInterface, ReverseOrientation,
  Attribute/Transform/Object Begin..End (recursive)

Argument type validation matches the reference (rgb length 3, blackbody pairs,
point/normal multiples of 3; `color` is an alias of `rgb`,
lib.rs:398).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from .ast import (Argument, AxisAngle, LookAt, Object, SceneStmt, TextureDecl,
                  Value, WorldStmt)


class Label:
    """A labeled source span in a diagnostic report (ariadne Label
    equivalent, main.rs:140-186)."""
    __slots__ = ("start", "end", "message", "kind")

    def __init__(self, start: int, end: int, message: str,
                 kind: str = "primary"):
        self.start = start
        self.end = max(end, start + 1)
        self.message = message
        self.kind = kind  # "primary" (^^^) | "hint" (---)


class ParseError(Exception):
    """Parse failure carrying labeled spans; `render()` produces the
    span-labeled report the reference prints via ariadne
    (rene/src/main.rs:129-190: message + red 'Unexpected token' label +
    yellow 'Unclosed delimiter' hint label)."""

    def __init__(self, msg: str, pos: int = -1, text: str = "",
                 end: Optional[int] = None, labels: Optional[list] = None,
                 label_msg: Optional[str] = None):
        self.msg = msg
        self.pos = pos
        self.text = text
        self.line, self.col = _line_col(text, pos) if pos >= 0 else (-1, -1)
        self.labels: List[Label] = []
        if pos >= 0:
            self.labels.append(Label(pos, end if end is not None else pos + 1,
                                     label_msg or msg, "primary"))
        if labels:
            self.labels.extend(labels)
        super().__init__(f"{msg} (line {self.line}, col {self.col})"
                         if pos >= 0 else msg)

    def render(self, path: str = "<input>") -> str:
        """Render a rustc/ariadne-style report with source excerpts:

            error: expected ], got ident 'Shape'
              --> scene.pbrt:7:3
               |
             7 |   Shape "sphere"
               |   ^^^^^ expected ], got ident 'Shape'
               |
             5 |   "float data" [ 1 2 3
               |                - unclosed delimiter '['
        """
        out = [f"error: {self.msg}"]
        if not self.labels or not self.text:
            return out[0]
        lines = self.text.splitlines() or [""]
        starts = [0]
        for ln in lines:
            starts.append(starts[-1] + len(ln) + 1)
        width = len(str(len(lines)))
        gutter = " " * width
        body = []
        head = None
        for lab in self.labels:
            pos = min(lab.start, len(self.text))
            line, col = _line_col(self.text, pos)
            li = min(line - 1, len(lines) - 1)
            src = lines[li]
            if li != line - 1:  # EOF after a trailing newline
                line, col = li + 1, len(src) + 1
            if head is None:
                head = (line, col)
            span = max(min(lab.end, starts[li] + len(src)) - pos, 1)
            mark = ("^" if lab.kind == "primary" else "-") * span
            body.append(f"{gutter} |")
            body.append(f"{line:>{width}} | {src}")
            body.append(f"{gutter} | {' ' * (col - 1)}{mark} {lab.message}")
        out.append(f"  --> {path}:{head[0]}:{head[1]}")
        out.extend(body)
        return "\n".join(out)


class MultiParseError(ParseError):
    """Several recovered parse errors from one run (the reference's
    chumsky `parse_recovery` reports a Vec of errors, each rendered as
    its own ariadne report, rene/src/main.rs:126-196)."""

    def __init__(self, errors: List[ParseError]):
        self.errors = errors
        first = errors[0]
        Exception.__init__(self, f"{len(errors)} parse errors")
        self.msg = f"{len(errors)} parse errors"
        self.pos = first.pos
        self.text = first.text
        self.line, self.col = first.line, first.col
        self.labels = first.labels

    def render(self, path: str = "<input>") -> str:
        return "\n\n".join(e.render(path) for e in self.errors)


def _line_col(text: str, pos: int) -> Tuple[int, int]:
    line = text.count("\n", 0, pos) + 1
    last_nl = text.rfind("\n", 0, pos)
    return line, pos - last_nl


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<comment>\#[^\n]*)
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<lbracket>\[)
    | (?P<rbracket>\])
    | (?P<number>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)

_ESCAPES = {"\\": "\\", "/": "/", '"': '"', "b": "\x08", "f": "\x0c",
            "n": "\n", "r": "\r", "t": "\t"}


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append(_ESCAPES.get(s[i + 1], s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class Token:
    __slots__ = ("kind", "text", "pos", "end")

    def __init__(self, kind: str, text: str, pos: int, end: int = -1):
        self.kind = kind   # "string" | "number" | "ident" | "[" | "]"
        self.text = text
        self.pos = pos
        self.end = end if end >= 0 else pos + max(len(text), 1)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Token({self.kind!r}, {self.text!r})"


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ParseError(f"unexpected character {text[pos]!r}", pos, text)
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        if kind == "string":
            tokens.append(Token("string", _unescape(m.group()[1:-1]),
                                m.start(), m.end()))
        elif kind == "number":
            tokens.append(Token("number", m.group(), m.start(), m.end()))
        elif kind == "ident":
            tokens.append(Token("ident", m.group(), m.start(), m.end()))
        elif kind == "lbracket":
            tokens.append(Token("[", "[", m.start(), m.end()))
        elif kind == "rbracket":
            tokens.append(Token("]", "]", m.start(), m.end()))
    return tokens


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_SCENE_OBJECTS = {"Camera", "Sampler", "Integrator", "PixelFilter", "Film"}
_WORLD_OBJECTS = {"LightSource", "AreaLightSource", "Material",
                  "MakeNamedMaterial", "MakeNamedMedium", "Shape"}
_ARG_TYPES = {"float", "bool", "integer", "string", "point", "normal",
              "texture", "blackbody", "rgb", "color", "spectrum",
              # common pbrt aliases kept lenient:
              "point3", "normal3", "point2", "vector", "vector3"}


_TRANSFORM_DIRECTIVES = {"Transform", "ConcatTransform", "Translate",
                         "Scale", "Rotate"}
_SCENE_SYNC = (_SCENE_OBJECTS | _TRANSFORM_DIRECTIVES
               | {"LookAt", "WorldBegin"})
_WORLD_SYNC = (_WORLD_OBJECTS | _TRANSFORM_DIRECTIVES
               | {"Texture", "NamedMaterial", "ObjectInstance",
                  "CoordSysTransform", "MediumInterface",
                  "ReverseOrientation", "AttributeBegin", "AttributeEnd",
                  "TransformBegin", "TransformEnd", "ObjectBegin",
                  "ObjectEnd", "WorldEnd"})

_BLOCK_CLOSERS = {"WorldEnd", "AttributeEnd", "TransformEnd", "ObjectEnd"}

MAX_PARSE_ERRORS = 8


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0
        self.errors: List[ParseError] = []

    def _recover(self, err: ParseError, sync: set, start_i: int) -> None:
        """Record a directive-level error and resync: skip tokens until
        the next known directive ident (or end of input), guaranteeing
        progress past `start_i`. The reference gets this from chumsky's
        parse_recovery; aborting after MAX_PARSE_ERRORS bounds cascade
        noise the same way editors cap diagnostics."""
        self.errors.append(err)
        if len(self.errors) >= MAX_PARSE_ERRORS:
            raise MultiParseError(self.errors)
        if self.i <= start_i:
            self.i = start_i + 1
        while True:
            t = self.peek()
            if t is None or (t.kind == "ident" and t.text in sync):
                return
            self.i += 1

    # -- token helpers ------------------------------------------------------
    def peek(self) -> Optional[Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self, hint: Optional[Label] = None) -> Token:
        t = self.peek()
        if t is None:
            raise ParseError(
                "unexpected end of input", len(self.text), self.text,
                label_msg="unexpected end of input",
                labels=[hint] if hint else None)
        self.i += 1
        return t

    def expect(self, kind: str, hint: Optional[Label] = None) -> Token:
        t = self.next(hint)
        if t.kind != kind:
            raise ParseError(
                f"expected {kind}, got {t.kind} {t.text!r}",
                t.pos, self.text, end=t.end,
                label_msg=f"unexpected token {t.text!r}",
                labels=[hint] if hint else None)
        return t

    def number(self) -> float:
        return float(self.expect("number").text)

    def string(self) -> str:
        return self.expect("string").text

    def vec3(self) -> np.ndarray:
        return np.array([self.number(), self.number(), self.number()],
                        dtype=np.float32)

    def mat4(self) -> np.ndarray:
        """16 bracketed floats, pbrt column-major -> row-major math matrix."""
        lb = self.expect("[")
        hint = Label(lb.pos, lb.end, "unclosed delimiter '['", "hint")
        vals = [self.number() for _ in range(16)]
        self.expect("]", hint)
        return np.array(vals, dtype=np.float32).reshape(4, 4).T

    # -- arguments ----------------------------------------------------------
    def _bracket_numbers(self) -> List[float]:
        lb = self.expect("[")
        hint = Label(lb.pos, lb.end, "unclosed delimiter '['", "hint")
        vals = []
        while self.peek() and self.peek().kind == "number":
            vals.append(float(self.next().text))
        self.expect("]", hint)
        return vals

    def _number_or_list(self) -> List[float]:
        t = self.peek()
        if t and t.kind == "[":
            return self._bracket_numbers()
        return [self.number()]

    def _string_or_list(self) -> List[str]:
        t = self.peek()
        if t and t.kind == "[":
            lb = self.next()
            hint = Label(lb.pos, lb.end, "unclosed delimiter '['", "hint")
            vals = []
            while self.peek() and self.peek().kind == "string":
                vals.append(self.next().text)
            self.expect("]", hint)
            return vals
        return [self.string()]

    def argument(self) -> Argument:
        decl = self.string()  # e.g. "float fov"
        parts = decl.split()
        if len(parts) != 2 or parts[0] not in _ARG_TYPES:
            raise ParseError(f"bad argument declaration {decl!r}",
                             self.toks[self.i - 1].pos, self.text)
        ty, name = parts
        tpos = self.toks[self.i - 1].pos
        if ty == "float":
            value = Value("float", self._number_or_list())
        elif ty == "integer":
            value = Value("integer", [int(v) for v in self._number_or_list()])
        elif ty == "bool":
            raw = self._string_or_list()
            value = Value("bool", [s == "true" for s in raw])
        elif ty in ("rgb", "color"):
            v = self._number_or_list()
            if len(v) != 3:
                raise ParseError(f"length of rgb must be 3. It was {len(v)}",
                                 tpos, self.text)
            value = Value("rgb", np.array(v, dtype=np.float32))
        elif ty == "blackbody":
            v = self._number_or_list()
            if len(v) % 2 != 0:
                raise ParseError(
                    f"length of blackbody value must be multiple of 2. "
                    f"It was {len(v)}", tpos, self.text)
            value = Value("blackbody",
                          np.array(v, dtype=np.float32).reshape(-1, 2))
        elif ty in ("point", "point3", "vector", "vector3"):
            v = self._number_or_list()
            if len(v) % 3 != 0:
                raise ParseError(
                    f"length of point value must be multiple of 3. "
                    f"It was {len(v)}", tpos, self.text)
            value = Value("point", np.array(v, dtype=np.float32).reshape(-1, 3))
        elif ty in ("normal", "normal3"):
            v = self._number_or_list()
            if len(v) % 3 != 0:
                raise ParseError(
                    f"length of normal value must be multiple of 3. "
                    f"It was {len(v)}", tpos, self.text)
            value = Value("normal",
                          np.array(v, dtype=np.float32).reshape(-1, 3))
        elif ty == "point2":
            value = Value("float", self._number_or_list())
        elif ty == "string":
            value = Value("string", self._string_or_list())
        elif ty == "texture":
            value = Value("texture", self._string_or_list())
        elif ty == "spectrum":
            # reference accepts a single (unbracketed) filename string
            value = Value("spectrum", self.string())
        else:  # pragma: no cover
            raise ParseError(f"unhandled argument type {ty}", tpos, self.text)
        return Argument(name, value)

    def arguments(self) -> List[Argument]:
        args = []
        while True:
            t = self.peek()
            if t is None or t.kind != "string":
                return args
            args.append(self.argument())

    # -- directives ---------------------------------------------------------
    def parse_scene(self) -> List[SceneStmt]:
        stmts: List[SceneStmt] = []
        while self.peek() is not None:
            start_i = self.i
            try:
                self._scene_directive(stmts)
            except MultiParseError:
                raise
            except ParseError as e:
                self._recover(e, _SCENE_SYNC, start_i)
        if self.errors:
            raise (self.errors[0] if len(self.errors) == 1
                   else MultiParseError(self.errors))
        return stmts

    def _scene_directive(self, stmts: List[SceneStmt]) -> None:
            t = self.expect("ident")
            name = t.text
            if name == "LookAt":
                stmts.append(SceneStmt("look_at",
                                       LookAt(self.vec3(), self.vec3(),
                                              self.vec3())))
            elif name == "Rotate":
                angle = self.number()
                stmts.append(SceneStmt("rotate", AxisAngle(self.vec3(), angle)))
            elif name == "Scale":
                stmts.append(SceneStmt("scale", self.vec3()))
            elif name == "Translate":
                stmts.append(SceneStmt("translate", self.vec3()))
            elif name == "Transform":
                stmts.append(SceneStmt("transform", self.mat4()))
            elif name == "ConcatTransform":
                stmts.append(SceneStmt("concat", self.mat4()))
            elif name in _SCENE_OBJECTS:
                subtype = self.string()
                stmts.append(SceneStmt(
                    "object", Object(name, subtype, self.arguments())))
            elif name == "WorldBegin":
                stmts.append(SceneStmt("world",
                                       self.parse_worlds("WorldEnd", t)))
            else:
                raise ParseError(f"unknown directive {name!r}", t.pos,
                                 self.text, end=t.end,
                                 label_msg=f"unexpected token {name!r}")

    def parse_worlds(self, terminator: str,
                     opener: Optional[Token] = None) -> List[WorldStmt]:
        hint = (Label(opener.pos, opener.end,
                      f"unclosed delimiter {opener.text!r}", "hint")
                if opener is not None else None)
        stmts: List[WorldStmt] = []
        while True:
            t = self.peek()
            if t is None:
                raise ParseError(
                    f"missing {terminator}", len(self.text), self.text,
                    label_msg="unexpected end of input",
                    labels=[hint] if hint else None)
            if t.kind == "ident" and t.text == terminator:
                self.next()
                return stmts
            if (t.kind == "ident" and t.text in _BLOCK_CLOSERS):
                # a closer for an OUTER block: this block's terminator
                # is missing. Report, leave the closer for the outer
                # block (prevents one missing End cascading into
                # unknown-directive noise at every level).
                self.errors.append(ParseError(
                    f"missing {terminator}", t.pos, self.text, end=t.end,
                    label_msg=f"expected {terminator} before {t.text!r}",
                    labels=[hint] if hint else None))
                if len(self.errors) >= MAX_PARSE_ERRORS:
                    raise MultiParseError(self.errors)
                return stmts
            start_i = self.i
            try:
                self._world_directive(stmts, t)
            except MultiParseError:
                raise
            except ParseError as e:
                self._recover(e, _WORLD_SYNC, start_i)

    def _world_directive(self, stmts: List[WorldStmt], t: Token) -> None:
            if t.kind != "ident":
                self.next()
                raise ParseError(f"expected directive, got {t.text!r}",
                                 t.pos, self.text, end=t.end,
                                 label_msg=f"unexpected token {t.text!r}")
            name = t.text
            self.next()
            if name in _WORLD_OBJECTS:
                subtype = self.string()
                stmts.append(WorldStmt(
                    "object", Object(name, subtype, self.arguments())))
            elif name == "Texture":
                tname = self.string()
                vtype = self.string()
                cls = self.string()
                stmts.append(WorldStmt("texture", TextureDecl(
                    tname, vtype, Object("Texture", cls, self.arguments()))))
            elif name == "NamedMaterial":
                stmts.append(WorldStmt("named_material", self.string()))
            elif name == "ObjectInstance":
                stmts.append(WorldStmt("object_instance", self.string()))
            elif name == "CoordSysTransform":
                stmts.append(WorldStmt("coord_sys_transform", self.string()))
            elif name == "MediumInterface":
                stmts.append(WorldStmt("medium_interface",
                                       (self.string(), self.string())))
            elif name == "ReverseOrientation":
                stmts.append(WorldStmt("reverse_orientation"))
            elif name == "Transform":
                stmts.append(WorldStmt("transform", self.mat4()))
            elif name == "ConcatTransform":
                stmts.append(WorldStmt("concat", self.mat4()))
            elif name == "Translate":
                stmts.append(WorldStmt("translate", self.vec3()))
            elif name == "Scale":
                stmts.append(WorldStmt("scale", self.vec3()))
            elif name == "Rotate":
                angle = self.number()
                stmts.append(WorldStmt("rotate", AxisAngle(self.vec3(), angle)))
            elif name == "AttributeBegin":
                stmts.append(WorldStmt(
                    "attribute", self.parse_worlds("AttributeEnd", t)))
            elif name == "TransformBegin":
                # The reference maps TransformBegin..End to the same node as
                # AttributeBegin (full state save/restore), lib.rs:561-566.
                stmts.append(WorldStmt(
                    "attribute", self.parse_worlds("TransformEnd", t)))
            elif name == "ObjectBegin":
                oname = self.string()
                stmts.append(WorldStmt(
                    "object_block",
                    (oname, self.parse_worlds("ObjectEnd", t))))
            else:
                raise ParseError(f"unknown world directive {name!r}", t.pos,
                                 self.text, end=t.end,
                                 label_msg=f"unexpected token {name!r}")


def parse_pbrt(text: str) -> List[SceneStmt]:
    """Parse a full pbrt file (after Include expansion) into AST statements."""
    return _Parser(text).parse_scene()

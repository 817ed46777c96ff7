# Frozen copy of rene_tpu_torch/pbrt/__init__.py at commit ed2dcef.
from .ast import (Argument, AxisAngle, LookAt, Object, SceneStmt, TextureDecl,
                  Value, WorldStmt)
from .include import expand_include
from .parser import MultiParseError, ParseError, parse_pbrt, tokenize

__all__ = [
    "Argument", "AxisAngle", "LookAt", "Object", "SceneStmt", "TextureDecl",
    "Value", "WorldStmt", "expand_include", "ParseError", "MultiParseError",
    "parse_pbrt", "tokenize",
]

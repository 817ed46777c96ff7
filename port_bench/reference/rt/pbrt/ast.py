"""Frozen copy of rene_tpu_torch/pbrt/ast.py at commit ed2dcef.

AST node types for the pbrt-v3 scene language.

Mirrors the directive surface of the reference parser
(pbrt-parser/src/lib.rs:6-112) with plain Python dataclasses:
pre-world directives (`Scene*`), world-block items (`World*`), typed argument
values, and the texture declaration.  Matrices are numpy (4,4) float32 arrays
in mathematical (row-major M @ p) convention; the pbrt `Transform` directive's
16 column-major floats are transposed at parse time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

Vec3 = np.ndarray  # shape (3,), float32


# ---------------------------------------------------------------------------
# Typed argument values (reference: pbrt-parser/src/lib.rs:57-69 `Value`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Value:
    kind: str  # float|bool|integer|rgb|blackbody|point|normal|string|texture|spectrum
    data: object

    # Convenience constructors --------------------------------------------
    @staticmethod
    def floats(v) -> "Value":
        return Value("float", [float(x) for x in v])

    @staticmethod
    def integers(v) -> "Value":
        return Value("integer", [int(x) for x in v])

    @staticmethod
    def rgb(r, g, b) -> "Value":
        return Value("rgb", np.array([r, g, b], dtype=np.float32))

    @staticmethod
    def strings(v) -> "Value":
        return Value("string", list(v))


@dataclasses.dataclass
class Argument:
    name: str
    value: Value


@dataclasses.dataclass
class Object:
    """A typed directive: `Shape "sphere" <args>` etc.

    reference: pbrt-parser/src/lib.rs:95-112 `Object<T>`.
    """

    object_type: str  # e.g. "Camera", "Shape", ...
    t: str            # subtype string, e.g. "perspective", "sphere"
    arguments: List[Argument] = dataclasses.field(default_factory=list)

    def get_value(self, name: str) -> Optional[Value]:
        for a in self.arguments:
            if a.name == name:
                return a.value
        return None


@dataclasses.dataclass
class TextureDecl:
    """`Texture "name" "valuetype" "class" <args>`."""

    name: str
    value_type: str
    obj: Object


@dataclasses.dataclass
class LookAt:
    eye: Vec3
    look_at: Vec3
    up: Vec3


@dataclasses.dataclass
class AxisAngle:
    axis: Vec3
    angle: float  # degrees


# ---------------------------------------------------------------------------
# World-block statements (reference lib.rs:32-48 `World`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorldStmt:
    kind: str
    # kind ->
    #   "object":       payload = Object (LightSource/AreaLightSource/Material/
    #                   MakeNamedMaterial/MakeNamedMedium/Shape)
    #   "attribute":    payload = [WorldStmt] (AttributeBegin..End; the reference
    #                   parses TransformBegin..End to the same node, lib.rs:561-566)
    #   "object_block": payload = (name, [WorldStmt])
    #   "object_instance": payload = name
    #   "transform":    payload = (4,4) matrix (replaces CTM)
    #   "concat":       payload = (4,4) matrix (right-multiplies CTM)
    #   "texture":      payload = TextureDecl
    #   "named_material": payload = name
    #   "medium_interface": payload = (interior, exterior)
    #   "coord_sys_transform": payload = name
    #   "reverse_orientation": payload = None
    payload: object = None


@dataclasses.dataclass
class SceneStmt:
    kind: str
    # kind ->
    #   "transform": payload = (4,4) matrix (replaces)
    #   "concat":    payload = (4,4) matrix (LookAt/Rotate/Scale/Translate/
    #                ConcatTransform all become right-multiplied matrices at
    #                the intermediate layer, but the parser keeps them typed)
    #   "look_at":   payload = LookAt
    #   "rotate":    payload = AxisAngle
    #   "scale" / "translate": payload = Vec3
    #   "object":    payload = Object (Camera/Sampler/Integrator/PixelFilter/Film)
    #   "world":     payload = [WorldStmt]
    payload: object = None

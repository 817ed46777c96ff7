"""Frozen copy of rene_tpu_torch/scene/flatten.py at commit ed2dcef.

Scene flattener: typed IR -> flat host-side scene tables.

Mirrors the reference's graphics-state machine
(rene/src/scene.rs:259-460): a `WorldState` carrying the CTM,
current material / area-light / medium-interface indices and the named
texture/material/medium/object maps; `Attribute` scopes clone the state
(only recorded objects escape); `ObjectBegin..End` records TLAS instances
which `ObjectInstance` replays with CTM composition; textures are interned
into one global table; anonymous colors become Solid texture entries.

Output is a `FlatScene`: Python lists of tagged-union rows, a TLAS instance
list, and the camera/film/integrator configuration — converted to device SoA
arrays by `rene_tpu_torch.scene.device`.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import types as T
from .assets.images import Image
from .assets.ply import TriangleMesh
from .intermediate import (CheckerTex, ConstantTex, DiffuseAreaLight,
                           DistantLight, Film, GlassM, HomogeneousMedium,
                           ImageMapTex, InfiniteLight, MatteM, MetalM,
                           MirrorM, NamedTexture, NoneM, PlasticM, SceneError,
                           ScaleTex, SphereShape, SubstrateM, UberM,
                           mat_perspective_lh, mat_scale, scene_to_ir)

log = logging.getLogger("rene_tpu_torch.scene")


@dataclasses.dataclass
class TlasInstance:
    kind: int  # T.KIND_TRIANGLE | T.KIND_SPHERE
    matrix: np.ndarray  # (4,4) object->world
    material_index: int
    area_light_index: int
    interior_medium_index: int
    exterior_medium_index: int
    blas_index: Optional[int]


@dataclasses.dataclass
class WorldState:
    current_material_index: int = 0
    current_medium_index: Optional[Tuple[int, int]] = None
    current_area_light_index: int = 0
    current_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    textures: Dict[str, int] = dataclasses.field(default_factory=dict)
    materials: Dict[str, int] = dataclasses.field(default_factory=dict)
    mediums: Dict[str, int] = dataclasses.field(default_factory=dict)
    objects: Dict[str, List[TlasInstance]] = dataclasses.field(
        default_factory=dict)
    coord_system: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def clone(self) -> "WorldState":
        return WorldState(
            self.current_material_index, self.current_medium_index,
            self.current_area_light_index, self.current_matrix.copy(),
            dict(self.textures), dict(self.materials), dict(self.mediums),
            dict(self.objects), dict(self.coord_system))


class FlatScene:
    def __init__(self):
        self.integrator: str = "path"
        self.max_depth_hint: Optional[int] = None
        self.pixel_filter: tuple = ("box", 0.5)  # (type, xwidth)
        self.sampler: str = "independent"  # or "sobol" (ops/sobol.py)
        self.film = Film()
        self.tlas: List[TlasInstance] = []
        self.blases: List[TriangleMesh] = []
        self.images: List[Image] = []
        # tagged-union tables (lists of rows)
        self.mat_type: List[int] = []
        self.mat_u0: List[List[int]] = []
        self.mat_u1: List[List[int]] = []
        self.mat_v0: List[List[float]] = []
        self.tex_type: List[int] = []
        self.tex_u0: List[List[int]] = []
        self.tex_v0: List[List[float]] = []
        self.med_type: List[int] = []
        self.med_sigma_a: List[np.ndarray] = []
        self.med_sigma_s: List[np.ndarray] = []
        self.med_g: List[float] = []
        self.area_type: List[int] = []
        self.area_color: List[np.ndarray] = []
        self.light_dir: List[np.ndarray] = []
        self.light_color: List[np.ndarray] = []
        # uniform
        self.camera_to_world = np.eye(4, dtype=np.float32)
        self.camera_proj_inv = np.eye(4, dtype=np.float32)
        self.camera_fov = 0.5 * math.pi
        self.camera_world_to_camera = np.eye(4, dtype=np.float32)
        self.background_color = np.zeros(3, dtype=np.float32)
        self.background_texture = 0
        self.background_matrix = np.eye(4, dtype=np.float32)

        # default entries (reference scene.rs:109-116)
        self._push_material_none()
        self.area_type.append(T.AREA_NULL)
        self.area_color.append(np.zeros(3, dtype=np.float32))
        self.med_type.append(T.MEDIUM_VACUUM)
        self.med_sigma_a.append(np.zeros(3, dtype=np.float32))
        self.med_sigma_s.append(np.zeros(3, dtype=np.float32))
        self.med_g.append(0.0)
        self._push_texture(T.TEX_SOLID, [0, 0, 0, 0], [1.0, 1.0, 1.0, 0.0])

    def set_film_resolution(self, xres: int, yres: int) -> None:
        """Set the film size and recompute the camera matrices (aspect +
        portrait-fov fix, reference scene.rs:155-165). Use this instead of
        mutating `film.xresolution` so non-uniform resizes keep correct
        primary rays."""
        self.film.xresolution = xres
        self.film.yresolution = yres
        fov = self.camera_fov
        aspect = xres / yres
        if yres > xres:
            # reference portrait-fov fix (scene.rs:156-162)
            fov = 2.0 * math.atan(math.tan(fov * 0.5) / xres * yres)
        proj = mat_perspective_lh(fov, aspect, 0.01, 1000.0)
        self.camera_proj_inv = np.linalg.inv(
            proj.astype(np.float64)).astype(np.float32)
        self.camera_to_world = np.linalg.inv(
            self.camera_world_to_camera.astype(np.float64)).astype(
                np.float32)

    # -- table builders ------------------------------------------------------
    def _push_texture(self, ttype, u0, v0) -> int:
        idx = len(self.tex_type)
        self.tex_type.append(ttype)
        self.tex_u0.append(list(u0))
        self.tex_v0.append(list(v0))
        return idx

    def _push_material(self, mtype, u0=(0, 0, 0, 0), u1=(0, 0, 0, 0),
                       v0=(0.0, 0.0, 0.0, 0.0)) -> int:
        idx = len(self.mat_type)
        self.mat_type.append(mtype)
        self.mat_u0.append(list(u0))
        self.mat_u1.append(list(u1))
        self.mat_v0.append(list(v0))
        return idx

    def _push_material_none(self) -> int:
        return self._push_material(T.MAT_NONE)

    def texture(self, toc, state: WorldState) -> int:
        """TextureOrColor -> texture table index (reference scene.rs:81-98)."""
        if isinstance(toc, str):
            if toc not in state.textures:
                raise SceneError(f"Not Found Texture: {toc}")
            return state.textures[toc]
        c = np.asarray(toc, dtype=np.float32)
        return self._push_texture(T.TEX_SOLID, [0, 0, 0, 0],
                                  [float(c[0]), float(c[1]), float(c[2]), 0.0])

    def material(self, state: WorldState, m) -> int:
        """Material IR -> material table row (reference scene.rs:170-257)."""
        tx = lambda t: self.texture(t, state)
        if isinstance(m, NoneM):
            return self._push_material_none()
        if isinstance(m, MatteM):
            return self._push_material(T.MAT_MATTE, u0=[tx(m.albedo), 0, 0, 0])
        if isinstance(m, GlassM):
            return self._push_material(T.MAT_GLASS,
                                       v0=[float(m.index), 0, 0, 0])
        if isinstance(m, SubstrateM):
            return self._push_material(
                T.MAT_SUBSTRATE,
                u0=[tx(m.diffuse), tx(m.specular), tx(m.rough_u),
                    tx(m.rough_v)],
                u1=[1 if m.remap_roughness else 0, 0, 0, 0])
        if isinstance(m, MetalM):
            return self._push_material(
                T.MAT_METAL,
                u0=[tx(m.eta), tx(m.k), tx(m.rough_u), tx(m.rough_v)],
                u1=[1 if m.remap_roughness else 0, 0, 0, 0])
        if isinstance(m, MirrorM):
            return self._push_material(T.MAT_MIRROR, u0=[tx(m.r), 0, 0, 0])
        if isinstance(m, UberM):
            return self._push_material(
                T.MAT_UBER,
                u0=[tx(m.kd), tx(m.ks), tx(m.kr), tx(m.kt)],
                u1=[tx(m.opacity), 1 if m.remap_roughness else 0,
                    tx(m.rough_u), tx(m.rough_v)],
                v0=[float(m.eta), 0, 0, 0])
        if isinstance(m, PlasticM):
            # NOTE: the reference writes remap into u0.z but reads u1.z
            # (material.rs:650-676), so its plastic never remaps; we store and
            # read consistently.
            return self._push_material(
                T.MAT_PLASTIC,
                u0=[tx(m.kd), tx(m.ks), 0, tx(m.rough)],
                u1=[0, 0, 1 if m.remap_roughness else 0, 0])
        raise SceneError(f"unknown material IR {type(m)}")

    # -- world walk (reference scene.rs append_world) -------------------------
    def append_world(self, state: WorldState, worlds) -> None:
        for kind, payload in worlds:
            if kind == "reverse_orientation":
                log.info("ReverseOrientation is not yet implemented")
            elif kind == "attribute":
                tmp = state.clone()
                self.append_world(tmp, payload)
                state.objects = tmp.objects
            elif kind == "object_block":
                name, inner = payload
                start = len(self.tlas)
                self.append_world(state, inner)
                recorded = self.tlas[start:]
                del self.tlas[start:]
                state.objects[name] = [dataclasses.replace(t)
                                       for t in recorded]
            elif kind == "object_instance":
                name = payload
                if name not in state.objects:
                    raise SceneError(f"Not Object: {name}")
                for t in state.objects[name]:
                    t2 = dataclasses.replace(t)
                    # reference: recorded.matrix * current (scene.rs:296)
                    t2.matrix = (t.matrix @ state.current_matrix).astype(
                        np.float32)
                    self.tlas.append(t2)
            elif kind == "matrix":
                state.current_matrix = (
                    state.current_matrix @ payload).astype(np.float32)
            elif kind == "transform":
                state.current_matrix = np.asarray(payload, dtype=np.float32)
            elif kind == "named_material":
                if payload not in state.materials:
                    raise SceneError(f"Unknown Material {payload}")
                state.current_material_index = state.materials[payload]
            elif kind == "coord_sys":
                if payload not in state.coord_system:
                    raise SceneError(f"Not Found Coord system: {payload}")
                state.current_matrix = state.coord_system[payload].copy()
            elif kind == "medium_interface":
                interior, exterior = payload

                def resolve(name):
                    if name == "":
                        return 0
                    if name not in state.mediums:
                        raise SceneError(f"Unknown Medium {name}")
                    return state.mediums[name]

                state.current_medium_index = (resolve(interior),
                                              resolve(exterior))
            elif kind == "texture":
                named: NamedTexture = payload
                inner = named.inner
                if isinstance(inner, ConstantTex):
                    idx = self._push_texture(
                        T.TEX_SOLID, [0, 0, 0, 0],
                        [*map(float, inner.value), 0.0])
                elif isinstance(inner, ScaleTex):
                    t1 = self.texture(inner.tex1, state)
                    t2 = self.texture(inner.tex2, state)
                    idx = self._push_texture(T.TEX_SCALE, [t1, t2, 0, 0],
                                             [0.0] * 4)
                elif isinstance(inner, CheckerTex):
                    t1 = self.texture(inner.tex1, state)
                    t2 = self.texture(inner.tex2, state)
                    idx = self._push_texture(
                        T.TEX_CHECKER, [t1, t2, 0, 0],
                        [float(inner.uscale), float(inner.vscale), 0.0, 0.0])
                elif isinstance(inner, ImageMapTex):
                    img_idx = len(self.images)
                    self.images.append(inner.image)
                    idx = self._push_texture(T.TEX_IMAGEMAP,
                                             [img_idx, 0, 0, 0], [0.0] * 4)
                else:
                    raise SceneError(f"unknown texture IR {type(inner)}")
                state.textures[named.name] = idx
            elif kind == "light":
                if isinstance(payload, InfiniteLight):
                    self.background_color = np.asarray(payload.color,
                                                       dtype=np.float32)
                    if payload.texture is not None:
                        # frontend extension: any named texture as the
                        # background (engine supports all 4 variants)
                        if payload.texture not in state.textures:
                            raise SceneError(
                                f"infinite light texture "
                                f"{payload.texture!r} not defined")
                        self.background_texture = \
                            state.textures[payload.texture]
                        self.background_matrix = np.linalg.inv(
                            state.current_matrix.astype(np.float64)).astype(
                                np.float32)
                    elif payload.image_map is not None:
                        img_idx = len(self.images)
                        self.images.append(payload.image_map)
                        tex_idx = self._push_texture(
                            T.TEX_IMAGEMAP, [img_idx, 0, 0, 0], [0.0] * 4)
                        self.background_matrix = np.linalg.inv(
                            state.current_matrix.astype(np.float64)).astype(
                                np.float32)
                        self.background_texture = tex_idx
                elif isinstance(payload, DistantLight):
                    d = (payload.from_p.astype(np.float64)
                         - payload.to_p.astype(np.float64))
                    d = d / np.linalg.norm(d)
                    self.light_dir.append(d.astype(np.float32))
                    self.light_color.append(
                        np.asarray(payload.color, dtype=np.float32))
                else:
                    raise SceneError("unknown light IR")
            elif kind == "area_light":
                al: DiffuseAreaLight = payload
                state.current_area_light_index = len(self.area_type)
                self.area_type.append(T.AREA_DIFFUSE)
                self.area_color.append(np.asarray(al.l, dtype=np.float32))
            elif kind == "material":
                idx = self.material(state, payload)
                state.current_material_index = idx
            elif kind == "named_material_def":
                name, m = payload
                idx = self.material(state, m)
                state.materials[name] = idx
                state.current_material_index = idx
            elif kind == "named_medium_def":
                name, med = payload
                state.mediums[name] = len(self.med_type)
                self.med_type.append(T.MEDIUM_HOMOGENEOUS)
                self.med_sigma_a.append(
                    np.asarray(med.sigma_a, dtype=np.float32))
                self.med_sigma_s.append(
                    np.asarray(med.sigma_s, dtype=np.float32))
                self.med_g.append(float(med.g))
            elif kind == "shape":
                interior, exterior = state.current_medium_index or (0, 0)
                if isinstance(payload, SphereShape):
                    r = payload.radius
                    self.tlas.append(TlasInstance(
                        T.KIND_SPHERE,
                        (state.current_matrix
                         @ mat_scale([r, r, r])).astype(np.float32),
                        state.current_material_index,
                        state.current_area_light_index,
                        interior, exterior, None))
                elif isinstance(payload, TriangleMesh):
                    blas_index = len(self.blases)
                    self.blases.append(payload)
                    self.tlas.append(TlasInstance(
                        T.KIND_TRIANGLE, state.current_matrix.copy(),
                        state.current_material_index,
                        state.current_area_light_index,
                        interior, exterior, blas_index))
                else:
                    raise SceneError(f"unknown shape IR {type(payload)}")
            else:
                raise SceneError(f"unknown world IR {kind}")


def create_scene(scene_stmts, base_dir: str,
                 color_space: str = "linear") -> FlatScene:
    """AST -> FlatScene (reference Scene::create, scene.rs:100-168).

    color_space: "linear" (pbrt/reference semantics) or "srgb" (decode rgb
    values like the original Tungsten scenes behind the shipped goldens).
    """
    from .intermediate import reset_color_space, set_color_space
    token = set_color_space(color_space)
    try:
        scene = FlatScene()
        world_to_camera = np.eye(4, dtype=np.float32)
        fov = 0.5 * math.pi

        for stmt in scene_stmts:
            kind, payload = scene_to_ir(stmt, base_dir)
            if kind == "sampler":
                if payload is not None:
                    scene.sampler = payload
                continue
            if kind == "pixel_filter":
                if payload is not None:
                    scene.pixel_filter = payload
                continue
            if kind == "integrator":
                scene.integrator, scene.max_depth_hint = payload
            elif kind == "film":
                scene.film = payload
            elif kind == "matrix":
                world_to_camera = (world_to_camera
                                   @ payload).astype(np.float32)
            elif kind == "transform":
                world_to_camera = np.asarray(payload, dtype=np.float32)
            elif kind == "camera":
                fov = payload
            elif kind == "world":
                state = WorldState()
                state.coord_system["camera"] = world_to_camera.copy()
                scene.append_world(state, payload)
            else:
                raise SceneError(f"unknown scene IR {kind}")
    finally:
        reset_color_space(token)

    scene.camera_fov = fov
    scene.camera_world_to_camera = world_to_camera
    scene.set_film_resolution(scene.film.xresolution,
                              scene.film.yresolution)
    return scene


def load_scene(path: str, color_space: str = "linear") -> FlatScene:
    """Parse + flatten a .pbrt file from disk."""
    import os

    from ..pbrt import expand_include, parse_pbrt
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        text = f.read()
    text = expand_include(text, base_dir)
    return create_scene(parse_pbrt(text), base_dir, color_space=color_space)

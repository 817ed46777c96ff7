"""Flat scene tables for the path megakernel (slices K1a, K1c, K1d).

Counterpart of these parts of rene_tpu/integrators/pallas_path.py:

* `pack_scene` (:1331-1453): which triangles and spheres stay immediates
  (`_immediate_tri_mask` :573, `_shared_split` :961, `_pack_sphere_table`
  :1203) and, for those, per-triangle Plücker and plane constants,
  shading normals, area and emission; per-sphere transforms; emit
  objects; distant lights. The rest (mesh triangles, shared-BLAS
  instances, table spheres) goes to `scene/accel.py`;
* `_mat_record` (:616-746) for solid textures: one record per material;
* `pallas_eligible` (:504-570) for what the port carries, as
  `slice_supported`.

The TPU kernel bakes these records into its program as immediates,
because Mosaic has no per-lane gather. A CUDA thread can gather, so the
port packs them into float32 tables that the kernel reads from device
memory: one build of the kernel serves every scene. Every constant is
computed on the host in float64 and then cast, as `pack_scene` does.
Parallelogram fusion (`_fuse_parallelograms`, :1059) is a TPU unroll
workaround and is not ported.

Row layouts are shared with the CUDA kernel through `csrc/layout.cuh`;
`tests/test_torch_frontend.py` holds the two equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from . import types as T
from .device import RenderConfig

from . import accel

MAX_TRIS = 512       # pallas_path.py:53
MAX_SPHERES = 64     # pallas_path.py:54
MAX_LIGHTS = 16      # pallas_path.py:55
SPH_TABLE_MAX = 1 << 15    # pallas_path.py:69
LIGHT_TABLE_MAX = 1024     # pallas_path.py:75
MESH_MAX_TRIS = 1 << 22    # pallas_path.py:92
RR_START = 12        # pallas_path.py:79

# texture payload slots each material reads (0..3 = u0.xyzw, 4..6 =
# u1.x/z/w). A copy of rene_tpu/ops/bsdf.py:77 _MAT_FETCHES, which imports
# jax at module load; tests hold the two equal.
_MAT_FETCHES = {
    T.MAT_NONE: (),
    T.MAT_MATTE: (0,),
    T.MAT_GLASS: (),
    T.MAT_SUBSTRATE: (0, 1, 2, 3),
    T.MAT_METAL: (0, 1, 2, 3),
    T.MAT_MIRROR: (0,),
    T.MAT_UBER: (0, 1, 2, 3, 4, 5, 6),
    T.MAT_PLASTIC: (0, 1, 3),
}

# -- row layouts (mirrored by csrc/layout.cuh) -------------------------------
TRI_M0, TRI_E0, TRI_M1, TRI_E1, TRI_M2, TRI_E2 = 0, 3, 6, 9, 12, 15
TRI_PN, TRI_PK = 18, 21
TRI_N0, TRI_N1, TRI_N2 = 22, 25, 28
TRI_AREA, TRI_GN, TRI_PRIMS = 31, 32, 35
TRI_EMIT, TRI_MAT = 36, 39          # emitted rgb (0 unless emissive), mat id
TRI_V0, TRI_V1, TRI_V2 = 40, 43, 46
TRI_W = 49

SPH_W2O, SPH_O2W = 0, 12            # 3x4 row-major affine matrices
SPH_EMIT, SPH_MAT, SPH_R2 = 24, 27, 28
SPH_W = 29

MAT_TYPE, MAT_ALBEDO, MAT_ETA, MAT_K = 0, 1, 4, 7
MAT_ALPHA, MAT_IR, MAT_OP, MAT_KR2 = 10, 12, 13, 16
MAT_KT2, MAT_FSCALE = 19, 22
MAT_W = 25

EO_KIND, EO_START, EO_COUNT, EO_CENTER, EO_R2 = 0, 1, 2, 3, 6
EO_W = 7

LIGHT_DIR, LIGHT_COLOR = 0, 3
LIGHT_W = 6

OUT_ROWS = 10   # kernel outputs: radiance rgb, normal xyz, albedo rgb, rays

CAM_PINV, CAM_C2W, CAM_ORIGIN = 0, 12, 24
CAM_INV_W1, CAM_INV_H1, CAM_FILTER, CAM_BG = 27, 28, 29, 30
CAM_W = 33


def _mat_tex_indices(buffers_np, mat_idx: int) -> List[int]:
    """Texture table indices a material row reads (pallas_path.py:475)."""
    mt = int(buffers_np["mat_type"][mat_idx])
    u0 = buffers_np["mat_u0"][mat_idx]
    u1 = buffers_np["mat_u1"][mat_idx]
    u1_slot = {4: 0, 5: 2, 6: 3}
    return [int(u0[s]) if s < 4 else int(u1[u1_slot[s]])
            for s in _MAT_FETCHES.get(mt, ())]


def _emissive(buffers_np, inst: np.ndarray) -> np.ndarray:
    """Per instance id: does it carry an area light."""
    al = buffers_np["inst_area_light"][inst]
    return buffers_np["area_type"][al] != T.AREA_NULL


def split_triangles(buffers_np, config: RenderConfig):
    """(immediate ids, world-mesh ids, [(blas id, [instance ids])]) of the
    scene's triangles. Up to MAX_TRIS triangles all stay immediates; past
    it, the emissive ones do (`_immediate_tri_mask` :573 with no textured
    material, which the port refuses) and the rest is the mesh, split
    into shared-BLAS instances and the world mesh by `_shared_split`."""
    ntri = config.num_triangles
    if ntri <= MAX_TRIS:
        return np.arange(ntri), np.zeros(0, np.int64), []
    em = _emissive(buffers_np, buffers_np["tri_inst"][:ntri])
    rest, shared = accel.shared_split(buffers_np, np.nonzero(~em)[0])
    return np.nonzero(em)[0], rest, shared


def split_spheres(buffers_np, config: RenderConfig):
    """(immediate ids, table ids) of the scene's spheres: past MAX_SPHERES,
    the non-emissive uniform-scale ones go to the sphere table
    (`_pack_sphere_table` :1203). The JAX package names two tests for
    "solid material" here (`_mat_solid_only` in `pallas_eligible`, no
    `texs` in `_pack_sphere_table`); the port refuses every non-solid
    material, so both hold for every sphere it packs."""
    ns = config.num_spheres
    if ns <= MAX_SPHERES:
        return np.arange(ns), np.zeros(0, np.int64)
    em = _emissive(buffers_np, buffers_np["sph_inst"][:ns])
    tbl = np.array([not em[s] and accel.sphere_uniform(
        buffers_np["sph_o2w"][s])[0] for s in range(ns)], bool)
    return np.nonzero(~tbl)[0], np.nonzero(tbl)[0]


def slice_supported(buffers_np, config: RenderConfig) -> None:
    """Raise NotImplementedError for a scene outside what the port
    carries (slices K1a, K1c, K1d), naming the ROADMAP item that will
    carry it. The caps are `pallas_eligible`'s (:504-570)."""
    def no(what, item):
        raise NotImplementedError(
            f"{what} is not in the port yet (ROADMAP Queue 2 {item})")

    if config.integrator != "path":
        no(f"integrator {config.integrator!r}", "K1e (volpath body)")
    if config.has_media:
        no("participating media", "K1e (volpath body)")
    if getattr(config, "sampler", "independent") == "sobol":
        no("the Sobol sampler", "K1a-sobol (Queue 1: Sobol)")
    if int(buffers_np["tex_type"][int(buffers_np["background_texture"])]) \
            != T.TEX_SOLID:
        no("a textured background", "K1b (textures and background)")
    for m in sorted(set(buffers_np["inst_material"].tolist())):
        for ti in _mat_tex_indices(buffers_np, int(m)):
            if int(buffers_np["tex_type"][ti]) != T.TEX_SOLID:
                no(f"material {m} with a non-solid texture slot",
                   "K1b (textures and background)")
    imm, rest, _ = split_triangles(buffers_np, config)
    if imm.size > MAX_TRIS:
        no(f"{imm.size} emissive triangles (> {MAX_TRIS})",
           "K1c (big-mesh closest/any hit)")
    if rest.size > MESH_MAX_TRIS:
        no(f"a {rest.size}-triangle mesh (> {MESH_MAX_TRIS})",
           "K1c (big-mesh closest/any hit)")
    imm_s, tbl_s = split_spheres(buffers_np, config)
    if imm_s.size > MAX_SPHERES:
        no(f"{imm_s.size} emissive or non-uniformly scaled spheres "
           f"(> {MAX_SPHERES})", "K1d (sphere and light tables)")
    if tbl_s.size > SPH_TABLE_MAX:
        no(f"{tbl_s.size} table spheres (> {SPH_TABLE_MAX})",
           "K1d (sphere and light tables)")
    if config.num_lights > LIGHT_TABLE_MAX:
        no(f"{config.num_lights} distant lights (> {LIGHT_TABLE_MAX})",
           "K1d (sphere and light tables)")


def _remap_rough(r: float) -> float:
    """pbrt roughness -> alpha polynomial (pallas_path.py:608)."""
    r = max(r, 1e-3)
    x = math.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def mat_record(buffers_np, mat_idx: int) -> dict:
    """`_mat_record` (pallas_path.py:616) for a material whose texture
    slots are all solid: plain python floats."""
    mt = int(buffers_np["mat_type"][mat_idx])
    u0 = buffers_np["mat_u0"][mat_idx]
    u1 = buffers_np["mat_u1"][mat_idx]
    v0 = buffers_np["mat_v0"][mat_idx]

    def tex_rgb(ti):
        return tuple(float(x) for x in buffers_np["tex_v0"][int(ti), :3])

    def rough(ti, remap):
        r = tex_rgb(ti)[0]
        return _remap_rough(r) if remap else r

    rec = {"mat_type": mt, "albedo": (0.0, 0.0, 0.0),
           "eta": (1.0, 1.0, 1.0), "k": (0.0, 0.0, 0.0),
           "alpha": (0.0, 0.0), "ir": 1.5,
           "op": (0.0, 0.0, 0.0), "kr2": (0.0, 0.0, 0.0),
           "kt2": (0.0, 0.0, 0.0), "fscale": (1.0, 1.0, 1.0)}
    if mt in (T.MAT_MATTE, T.MAT_MIRROR):
        rec["albedo"] = tex_rgb(u0[0])
    elif mt == T.MAT_GLASS:
        rec["ir"] = float(v0[0])
    elif mt == T.MAT_SUBSTRATE:
        rec["albedo"] = tex_rgb(u0[0])
        rec["k"] = tex_rgb(u0[1])
        remap = bool(int(u1[0]))
        rec["alpha"] = (rough(u0[2], remap), rough(u0[3], remap))
    elif mt == T.MAT_METAL:
        rec["eta"] = tex_rgb(u0[0])
        rec["k"] = tex_rgb(u0[1])
        rec["fscale"] = tuple(1.0 if float(v) == 0.0 else float(v)
                              for v in v0[:3])
        remap = bool(int(u1[0]))
        rec["alpha"] = (rough(u0[2], remap), rough(u0[3], remap))
        rec["albedo"] = rec["k"]
    elif mt == T.MAT_PLASTIC:
        rec["albedo"] = tex_rgb(u0[0])
        rec["k"] = tex_rgb(u0[1])
        remap = bool(int(u1[2]))
        rec["alpha"] = (rough(u0[3], remap), rough(u0[3], remap))
    elif mt == T.MAT_UBER:
        rec["albedo"] = tex_rgb(u0[0])
        rec["k"] = tex_rgb(u0[1])
        kr = tex_rgb(u0[2])
        kt = tex_rgb(u0[3])
        op = tex_rgb(u1[0])
        rec["op"] = tuple(1.0 - c for c in op)
        rec["kr2"] = tuple(op[i] * kr[i] for i in range(3))
        rec["kt2"] = tuple(op[i] * kt[i] for i in range(3))
        rec["ir"] = float(v0[0])
        remap = bool(int(u1[1]))
        rec["alpha"] = (rough(u1[2], remap), rough(u1[3], remap))
    return rec


def sphere_radius(m) -> float:
    """World radius of a unit sphere under a 3x4 o2w (pallas_path.py:599)."""
    return sum(math.sqrt(m[0][c] ** 2 + m[1][c] ** 2 + m[2][c] ** 2)
               for c in range(3)) / 3.0


def pack_records(buffers_np, config: RenderConfig, tri_ids=None,
                 sph_ids=None):
    """(tris, spheres, emit_objects, lights) as python-float dicts, field
    for field as pack_scene's immediates branch builds them, for the
    immediate triangles `tri_ids` and spheres `sph_ids` (default: all)."""
    if tri_ids is None:
        tri_ids = range(config.num_triangles)
    if sph_ids is None:
        sph_ids = range(config.num_spheres)
    tris = []
    for i in tri_ids:
        p = buffers_np["tri_p"][i].astype(np.float64)
        n = buffers_np["tri_n"][i].astype(np.float64)
        inst = int(buffers_np["tri_inst"][i])
        al = int(buffers_np["inst_area_light"][inst])
        v0, v1, v2 = p[0], p[1], p[2]
        gn = np.cross(v1 - v0, v2 - v0)
        rec = {
            "m0": tuple(np.cross(v0, v1)), "e0": tuple(v1 - v0),
            "m1": tuple(np.cross(v1, v2)), "e1": tuple(v2 - v1),
            "m2": tuple(np.cross(v2, v0)), "e2": tuple(v0 - v2),
            "pn": tuple(gn), "pk": float(np.dot(gn, v0)),
            "n0": tuple(n[0]), "n1": tuple(n[1]), "n2": tuple(n[2]),
            "area": float(0.5 * np.linalg.norm(gn)),
            "gn_unit": tuple(gn / max(np.linalg.norm(gn), 1e-20)),
            "prim_count": int(buffers_np["inst_prim_count"][inst]),
            "emissive": int(buffers_np["area_type"][al]) != T.AREA_NULL,
            "emit": tuple(float(x) for x in buffers_np["area_color"][al]),
            "v0": tuple(v0), "v1": tuple(v1), "v2": tuple(v2),
            "mat_id": int(buffers_np["inst_material"][inst]),
        }
        rec.update(mat_record(buffers_np, rec["mat_id"]))
        tris.append(rec)

    spheres = []
    for s in sph_ids:
        inst = int(buffers_np["sph_inst"][s])
        al = int(buffers_np["inst_area_light"][inst])
        rec = {
            "w2o": buffers_np["sph_w2o"][s].astype(float).tolist(),
            "o2w": buffers_np["sph_o2w"][s].astype(float).tolist(),
            "emissive": int(buffers_np["area_type"][al]) != T.AREA_NULL,
            "emit": tuple(float(x) for x in buffers_np["area_color"][al]),
            "mat_id": int(buffers_np["inst_material"][inst]),
        }
        rec.update(mat_record(buffers_np, rec["mat_id"]))
        spheres.append(rec)

    emit_objects = []
    for e in range(config.num_emit_objects):
        if int(buffers_np["eo_kind"][e]) == T.KIND_TRIANGLE:
            emit_objects.append({
                "kind": "tri", "start": int(buffers_np["eo_tri_start"][e]),
                "count": int(buffers_np["eo_prim_count"][e])})
        else:
            emit_objects.append({
                "kind": "sphere",
                "o2w": buffers_np["eo_matrix"][e].astype(float).tolist()})

    lights = [{"dir": tuple(float(x) for x in buffers_np["light_dir"][li]),
               "color": tuple(float(x) for x in buffers_np["light_color"][li])}
              for li in range(config.num_lights)]
    return tris, spheres, emit_objects, lights


def _background(buffers_np) -> tuple:
    """Solid miss radiance: texture rgb x background_color (:1552)."""
    rgb = buffers_np["tex_v0"][int(buffers_np["background_texture"]), :3]
    bg = buffers_np["background_color"]
    return tuple(float(rgb[i]) * float(bg[i]) for i in range(3))


def max_depth_for(config: RenderConfig) -> int:
    """rene_tpu/integrators/path.py:52."""
    if config.max_depth_hint is not None:
        return max(int(config.max_depth_hint), 1)
    return 50


@dataclasses.dataclass
class SceneTables:
    """Everything the path kernel reads, as numpy float32/int32. The
    acceleration tables (scene/accel.py) are empty for a scene that fits
    the immediates budget."""
    tris: np.ndarray         # (T, TRI_W) immediate triangles
    spheres: np.ndarray      # (S, SPH_W) immediate spheres
    mats: np.ndarray         # (M, MAT_W)
    emit_objects: np.ndarray  # (E, EO_W)
    emit_tris: np.ndarray    # int32 indices of emissive triangles
    emit_spheres: np.ndarray  # int32 indices of emissive spheres
    lights: np.ndarray       # (L, LIGHT_W)
    light_dots: np.ndarray   # (L, T, 4): dir . (m0, m1, m2, pn)
    cam: np.ndarray          # (CAM_W,)
    nodes: np.ndarray        # (K, NODE_W) BVH nodes, world mesh and BLASes
    mesh: np.ndarray         # (P, MESH_W) leaf-ordered mesh triangles
    insts: np.ndarray        # (I, INST_W) shared-BLAS instances
    sph_tab: np.ndarray      # (B * SPH_BLOCK, SPHT_W) table spheres
    sph_box: np.ndarray      # (B, BOX_W) their 128-slot block boxes
    width: int
    height: int
    max_depth: int
    world_root: int          # root node of the world mesh, -1 if none
    bvh_depth: int           # deepest root-to-leaf path of any BVH
    max_leaf: int            # most triangles in one BVH leaf

    @property
    def use_rr(self) -> bool:
        return self.max_depth > RR_START + 1

    @property
    def has_accel(self) -> bool:
        """The scene needs the mesh variant of the kernel."""
        return bool(self.nodes.shape[0] or self.sph_tab.shape[0])

    @property
    def block_seed(self) -> bool:
        """Lane streams are seeded per 32x32 pixel block, as the JAX
        kernel's cluster mode tiles the film (`make_pallas_batch_fn`
        :5892-5938): a world mesh or shared-BLAS instances."""
        return bool(self.world_root >= 0 or self.insts.shape[0])

    def arrays(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), np.ndarray)}


def pack_tables(buffers_np, config: RenderConfig) -> SceneTables:
    slice_supported(buffers_np, config)
    imm, rest, shared = split_triangles(buffers_np, config)
    imm_s, tbl_s = split_spheres(buffers_np, config)
    tris, spheres, emit_objects, lights = pack_records(buffers_np, config,
                                                       imm, imm_s)
    n_mats = buffers_np["mat_type"].shape[0]

    mats = np.zeros((n_mats, MAT_W), np.float64)
    for m in range(n_mats):
        r = mat_record(buffers_np, m)
        mats[m, MAT_TYPE] = r["mat_type"]
        mats[m, MAT_ALBEDO:MAT_ALBEDO + 3] = r["albedo"]
        mats[m, MAT_ETA:MAT_ETA + 3] = r["eta"]
        mats[m, MAT_K:MAT_K + 3] = r["k"]
        mats[m, MAT_ALPHA:MAT_ALPHA + 2] = r["alpha"]
        mats[m, MAT_IR] = r["ir"]
        mats[m, MAT_OP:MAT_OP + 3] = r["op"]
        mats[m, MAT_KR2:MAT_KR2 + 3] = r["kr2"]
        mats[m, MAT_KT2:MAT_KT2 + 3] = r["kt2"]
        mats[m, MAT_FSCALE:MAT_FSCALE + 3] = r["fscale"]

    tt = np.zeros((len(tris), TRI_W), np.float64)
    for i, r in enumerate(tris):
        for key, off in (("m0", TRI_M0), ("e0", TRI_E0), ("m1", TRI_M1),
                         ("e1", TRI_E1), ("m2", TRI_M2), ("e2", TRI_E2),
                         ("pn", TRI_PN), ("n0", TRI_N0), ("n1", TRI_N1),
                         ("n2", TRI_N2), ("gn_unit", TRI_GN),
                         ("v0", TRI_V0), ("v1", TRI_V1), ("v2", TRI_V2)):
            tt[i, off:off + 3] = r[key]
        tt[i, TRI_PK] = r["pk"]
        tt[i, TRI_AREA] = r["area"]
        tt[i, TRI_PRIMS] = r["prim_count"]
        if r["emissive"]:
            tt[i, TRI_EMIT:TRI_EMIT + 3] = r["emit"]
        tt[i, TRI_MAT] = r["mat_id"]

    st = np.zeros((len(spheres), SPH_W), np.float64)
    for s, r in enumerate(spheres):
        st[s, SPH_W2O:SPH_W2O + 12] = np.asarray(r["w2o"]).reshape(-1)
        st[s, SPH_O2W:SPH_O2W + 12] = np.asarray(r["o2w"]).reshape(-1)
        if r["emissive"]:
            st[s, SPH_EMIT:SPH_EMIT + 3] = r["emit"]
        st[s, SPH_MAT] = r["mat_id"]
        radius = sphere_radius(r["o2w"])
        st[s, SPH_R2] = radius * radius

    # an emit object's triangles are emissive, so immediates, and
    # consecutive there as in the scene's triangle list: its start moves
    # to its first triangle's row of the immediates table
    row_of = np.full(max(config.num_triangles, 1), -1, np.int64)
    row_of[imm] = np.arange(imm.size)
    eo = np.zeros((len(emit_objects), EO_W), np.float64)
    for e, r in enumerate(emit_objects):
        if r["kind"] == "tri":
            eo[e, EO_KIND] = T.KIND_TRIANGLE
            eo[e, EO_START] = row_of[r["start"]]
            eo[e, EO_COUNT] = r["count"]
            assert row_of[r["start"]] >= 0
        else:
            m = r["o2w"]
            radius = sphere_radius(m)
            eo[e, EO_KIND] = T.KIND_SPHERE
            eo[e, EO_COUNT] = 1
            eo[e, EO_CENTER:EO_CENTER + 3] = (m[0][3], m[1][3], m[2][3])
            eo[e, EO_R2] = radius * radius

    lt = np.zeros((len(lights), LIGHT_W), np.float64)
    for li, r in enumerate(lights):
        lt[li, LIGHT_DIR:LIGHT_DIR + 3] = r["dir"]
        lt[li, LIGHT_COLOR:LIGHT_COLOR + 3] = r["color"]
    # the const-direction shadow test's d . c per light and immediate
    # triangle (pallas_path.py:3125 ddot with dir_scalars)
    c = np.asarray([[tr[k] for k in ("m0", "m1", "m2", "pn")]
                    for tr in tris], np.float64).reshape(len(tris), 4, 3)
    d = lt[:, None, None, LIGHT_DIR:LIGHT_DIR + 3]
    if len(lights) > MAX_LIGHTS:
        # light table (`fold_lights` :2696): the kernel multiplies its
        # float32 row reads by the constants rounded to float32, in
        # float32; numpy float32 does the same operations in that order
        d, c = d.astype(np.float32), c.astype(np.float32)
    # else unrolled lights: python floats, folded in float64 on the host
    dots = (d[..., 0] * c[None, ..., 0] + d[..., 1] * c[None, ..., 1]
            + d[..., 2] * c[None, ..., 2])

    w, h = config.film.xresolution, config.film.yresolution
    pinv = np.asarray(buffers_np["camera_proj_inv"], np.float64)
    c2w = np.asarray(buffers_np["camera_to_world"], np.float64)
    cam = np.zeros(CAM_W, np.float64)
    cam[CAM_PINV:CAM_PINV + 12] = pinv[:3, :4].reshape(-1)
    cam[CAM_C2W:CAM_C2W + 12] = c2w[:3, :4].reshape(-1)
    cam[CAM_ORIGIN:CAM_ORIGIN + 3] = c2w[:3, 3]
    cam[CAM_INV_W1] = 1.0 / max(w - 1, 1)
    cam[CAM_INV_H1] = 1.0 / max(h - 1, 1)
    cam[CAM_FILTER] = float(getattr(config, "filter_radius", 0.0))
    cam[CAM_BG:CAM_BG + 3] = _background(buffers_np)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return SceneTables(
        tris=f32(tt), spheres=f32(st), mats=f32(mats),
        emit_objects=f32(eo),
        emit_tris=np.asarray([i for i, r in enumerate(tris) if r["emissive"]],
                             np.int32),
        emit_spheres=np.asarray(
            [s for s, r in enumerate(spheres) if r["emissive"]], np.int32),
        lights=f32(lt), light_dots=f32(dots), cam=f32(cam),
        width=w, height=h, max_depth=max_depth_for(config),
        **accel.pack_accel(buffers_np, rest, shared, tbl_s))

"""Flat scene tables for the path kernels (slices K1a-K1e).

Counterpart of these parts of rene_tpu/integrators/pallas_path.py:

* `pack_scene` (:1331-1453): which triangles and spheres stay immediates
  (`_immediate_tri_mask` :573, `_shared_split` :961, `_pack_sphere_table`
  :1203) and, for those, per-triangle Plücker and plane constants,
  shading normals, area and emission; per-sphere transforms; emit
  objects; distant lights. The rest (mesh triangles, shared-BLAS
  instances, table spheres) goes to `scene/accel.py`;
* `_mat_record` (:616-746): one record per material, with a descriptor
  per textured slot class (`_tex_kernel_desc` :368, `_SLOT_CLASSES` :418,
  `_mat_slot_descs` :431): a checker with solid subs, an imagemap, a
  scale folded into its base;
* the image atlas and the background of `pack_scene` (:1472-1571): the
  images the kernel fetches (`_kernel_images` :453) back to back in one
  flat array of RGB9E5 words, without the TPU's 128-lane rows and 8-row
  pages; the background as a constant, an image or a checker; and the
  env-map sampling tables as scene/device.py builds them (the reference
  transposes them into a lane-gather layout, `env_tab`, which a CUDA
  thread does not need);
* `pallas_eligible` (:504-570) for what the port carries, as
  `slice_supported`, under the independent and the Sobol sampler. The
  reference's texel caps (`MAX_IMG_TEXELS` :364-365) are the size of the
  TPU's VMEM and are not carried over: the
  port's atlas lies in device memory and is capped at 2^24 texels, where
  a texel offset stops being exact in a float32 table.

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
from .device import ENV_GH, ENV_GW, RenderConfig

from .. import trace
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
TRI_UV0, TRI_UV1, TRI_UV2 = 49, 51, 53   # per-vertex (u, v)
TRI_W = 55

SPH_W2O, SPH_O2W = 0, 12            # 3x4 row-major affine matrices
SPH_EMIT, SPH_MAT, SPH_R2 = 24, 27, 28
SPH_W = 29

MAT_TYPE, MAT_ALBEDO, MAT_ETA, MAT_K = 0, 1, 4, 7
MAT_ALPHA, MAT_IR, MAT_OP, MAT_KR2 = 10, 12, 13, 16
MAT_KT2, MAT_FSCALE = 19, 22
# textured slots: MAT_NTEX counts the classes that are not solid,
# MAT_RRM asks for the roughness remap of an imagemap roughness per hit,
# then one TEXD_W-wide descriptor per class of IMG_CLASSES: its kind and
# either (uscale, vscale, even rgb, odd rgb) or (texel offset, w, h)
MAT_NTEX, MAT_RRM, MAT_TEX = 25, 26, 27
TEXD_KIND = 0
TEXD_US, TEXD_VS, TEXD_EVEN, TEXD_ODD = 1, 2, 3, 6
TEXD_OFF, TEXD_IW, TEXD_IH = 1, 2, 3
# 1 where an image class's image is the previous image class's of the
# row: the kernel reuses that fetch, at the same uv
TEXD_SAME = 4
TEXD_W = 9
TEXK_SOLID, TEXK_CHECKER, TEXK_IMAGE = 0, 1, 2
N_TEX_CLASSES = 7
# a row of the material table is a material slot: the material's row and
# the interior and exterior medium of the surfaces that carry it
MAT_IMED = MAT_TEX + N_TEX_CLASSES * TEXD_W    # 90
MAT_EMED = MAT_IMED + 1
MAT_W = MAT_EMED + 1                          # 92

# homogeneous media (`media` of pack_scene :1460): sigma_t = sigma_a +
# sigma_s rgb, sigma_s rgb, the Henyey-Greenstein g, 1 for vacuum; row 0
# is vacuum
MED_ST, MED_SS, MED_G, MED_VAC = 0, 3, 6, 7
MED_W = 8

EO_KIND, EO_START, EO_COUNT, EO_CENTER, EO_R2 = 0, 1, 2, 3, 6
EO_W = 7

LIGHT_DIR, LIGHT_COLOR = 0, 3
LIGHT_W = 6

OUT_ROWS = 10   # kernel outputs: radiance rgb, normal xyz, albedo rgb, rays

CAM_PINV, CAM_C2W, CAM_ORIGIN = 0, 12, 24
CAM_INV_W1, CAM_INV_H1, CAM_FILTER, CAM_BG = 27, 28, 29, 30
# the background: CAM_BG is the constant colour (background_color x a
# solid texture or an image's scale base); a textured one multiplies it
# by the env image (texel offset, w, h) or the checker (uscale, vscale,
# even rgb, odd rgb) at the spherical uv of CAM_BG_MAT d; CAM_BG_INV, the
# inverse 3x3, takes env-map samples back to world space
CAM_BG_KIND, CAM_BG_IMG, CAM_BG_CHK = 33, 34, 37
CAM_BG_MAT, CAM_BG_INV = 45, 54
CAM_W = 63
BG_CONST, BG_IMAGE, BG_CHECKER = 0, 1, 2
MAX_ATLAS_TEXELS = 1 << 24
# the env-map searches' guide tables (`env_guides`): per cdf (the
# marginal, then each conditional row) ENV_GUIDE uint8 entries, entry b
# the first index whose cdf value is >= b / ENV_GUIDE
ENV_GUIDE = 256
# The immediates' cast rows (`imm_rows`), which the kernels copy into
# shared memory: per triangle IMM_TRI_W floats, the plane (pn, pk) and
# the Plücker moment and edge of each side, padded to six float4; per
# sphere its 3x4 world-to-object matrix, three float4
IMM_PN, IMM_PK, IMM_M0, IMM_E0, IMM_M1, IMM_E1, IMM_M2, IMM_E2 = (
    0, 3, 4, 7, 10, 13, 16, 19)
IMM_TRI_W, IMM_SPH_W = 24, 12


def _mat_tex_indices(buffers_np, mat_idx: int) -> List[int]:
    """Texture table indices a material row reads (pallas_path.py:475)."""
    mt = int(buffers_np["mat_type"][mat_idx])
    u0 = buffers_np["mat_u0"][mat_idx]
    u1 = buffers_np["mat_u1"][mat_idx]
    u1_slot = {4: 0, 5: 2, 6: 3}
    return [int(u0[s]) if s < 4 else int(u1[u1_slot[s]])
            for s in _MAT_FETCHES.get(mt, ())]


def tex_kernel_desc(buffers_np, ti: int):
    """`_tex_kernel_desc` (pallas_path.py:368): the descriptor of texture
    `ti` where the kernel can evaluate it: ("solid", rgb), ("checker",
    us, vs, rgb_even, rgb_odd) with solid sub-textures, ("image",
    img_idx, base_rgb) for an imagemap or a scale of an imagemap and a
    solid (folded into base_rgb); None otherwise."""
    tt = int(buffers_np["tex_type"][ti])

    def srgb(s):
        return tuple(float(x) for x in buffers_np["tex_v0"][s, :3])

    if tt == T.TEX_SOLID:
        return ("solid", srgb(ti))
    if tt == T.TEX_IMAGEMAP:
        return ("image", int(buffers_np["tex_u0"][ti, 0]), (1.0, 1.0, 1.0))
    subs = [int(buffers_np["tex_u0"][ti, s]) for s in (0, 1)]
    kinds = [int(buffers_np["tex_type"][s]) for s in subs]
    if tt == T.TEX_CHECKER:
        if all(k == T.TEX_SOLID for k in kinds):
            tv = buffers_np["tex_v0"][ti]
            return ("checker", float(tv[0]), float(tv[1]),
                    srgb(subs[0]), srgb(subs[1]))
        return None
    if tt == T.TEX_SCALE:
        imgs = [s for s, k in zip(subs, kinds) if k == T.TEX_IMAGEMAP]
        solids = [s for s, k in zip(subs, kinds) if k == T.TEX_SOLID]
        if len(imgs) + len(solids) != 2 or len(imgs) > 1:
            return None
        base = (1.0, 1.0, 1.0)
        for s in solids:
            c = srgb(s)
            base = tuple(base[i] * c[i] for i in range(3))
        if imgs:
            return ("image", int(buffers_np["tex_u0"][imgs[0], 0]), base)
        return ("solid", base)
    return None


# payload slot -> slot class per material (`_SLOT_CLASSES` :418): kd
# feeds the albedo rows, ks the k rows, ru / rv the two alphas (rp is
# plastic's one roughness, driving both), op uber's opacity with the
# Kr / Kt products, kr / kt uber's Kr and Kt. Metal's eta and k stay
# solid-only.
SLOT_CLASSES = {
    T.MAT_MATTE: {0: "kd"},
    T.MAT_MIRROR: {0: "kd"},
    T.MAT_SUBSTRATE: {0: "kd", 1: "ks", 2: "ru", 3: "rv"},
    T.MAT_METAL: {2: "ru", 3: "rv"},
    T.MAT_PLASTIC: {0: "kd", 1: "ks", 3: "rp"},
    T.MAT_UBER: {0: "kd", 1: "ks", 2: "kr", 3: "kt", 4: "op",
                 5: "ru", 6: "rv"},
}
# the classes a material row holds a descriptor for (rp expands to ru, rv)
IMG_CLASSES = ("kd", "ks", "ru", "rv", "op", "kr", "kt")
assert len(IMG_CLASSES) == N_TEX_CLASSES


def mat_slot_descs(buffers_np, mat_idx: int):
    """`_mat_slot_descs` (:431): {class: descriptor} of every non-solid
    texture slot of a material, or None if the kernel cannot evaluate
    one of them."""
    mt = int(buffers_np["mat_type"][mat_idx])
    cls_map = SLOT_CLASSES.get(mt, {})
    out = {}
    for slot, ti in enumerate(_mat_tex_indices(buffers_np, mat_idx)):
        if int(buffers_np["tex_type"][ti]) == T.TEX_SOLID:
            continue
        cls = cls_map.get(slot)
        if cls is None:
            return None
        desc = tex_kernel_desc(buffers_np, ti)
        if desc is None:
            return None
        if cls == "op" and desc[0] == "image" \
                and tuple(desc[2]) != (1.0, 1.0, 1.0):
            return None  # op applies 1 - v; a scale base has no fold
        out[cls] = desc
    return out


def mat_solid_only(buffers_np, mat_idx: int) -> bool:
    return all(int(buffers_np["tex_type"][t]) == T.TEX_SOLID
               for t in _mat_tex_indices(buffers_np, mat_idx))


def kernel_images(buffers_np):
    """`_kernel_images` (:453): ids of the images the kernel fetches, the
    background's and every used material slot's, sorted."""
    used = set()
    bg = tex_kernel_desc(buffers_np, int(buffers_np["background_texture"]))
    if bg is not None and bg[0] == "image":
        used.add(bg[1])
    for m in set(buffers_np["inst_material"].tolist()):
        for desc in (mat_slot_descs(buffers_np, int(m)) or {}).values():
            if desc[0] == "image":
                used.add(desc[1])
    return sorted(used)


def _emissive(buffers_np, inst: np.ndarray) -> np.ndarray:
    """Per instance id: does it carry an area light."""
    al = buffers_np["inst_area_light"][inst]
    return buffers_np["area_type"][al] != T.AREA_NULL


def immediate_tri_mask(buffers_np, config: RenderConfig) -> np.ndarray:
    """`_immediate_tri_mask` (:573): the triangles that stay immediates
    in a scene past MAX_TRIS. Emissive ones always do; those whose
    material reads a texture do while both kinds together fit under
    MAX_TRIS."""
    ntri = config.num_triangles
    inst = buffers_np["tri_inst"][:ntri]
    em = _emissive(buffers_np, inst)
    n_mats = buffers_np["mat_type"].shape[0]
    solid = np.array([mat_solid_only(buffers_np, m) for m in range(n_mats)],
                     bool)
    with_tex = em | ~solid[buffers_np["inst_material"][inst]]
    return with_tex if int(with_tex.sum()) <= MAX_TRIS else em


def split_triangles(buffers_np, config: RenderConfig):
    """(immediate ids, world-mesh ids, [(blas id, [instance ids])]) of the
    scene's triangles. Up to MAX_TRIS triangles all stay immediates; past
    it, `immediate_tri_mask` picks them and the rest is the mesh, split
    into shared-BLAS instances and the world mesh by `_shared_split`."""
    ntri = config.num_triangles
    if ntri <= MAX_TRIS:
        return np.arange(ntri), np.zeros(0, np.int64), []
    imm = immediate_tri_mask(buffers_np, config)
    rest, shared = accel.shared_split(buffers_np, np.nonzero(~imm)[0])
    return np.nonzero(imm)[0], rest, shared


def mesh_needs_uv(buffers_np, mesh_idx: np.ndarray) -> bool:
    """`_mesh_needs_uv` (:591): some mesh triangle's material reads a
    texture, so the mesh carries uv rows."""
    mats = set(buffers_np["inst_material"][
        buffers_np["tri_inst"][mesh_idx]].tolist())
    return not all(mat_solid_only(buffers_np, int(m)) for m in mats)


def split_spheres(buffers_np, config: RenderConfig):
    """(immediate ids, table ids) of the scene's spheres: past MAX_SPHERES,
    the non-emissive uniform-scale ones go to the sphere table
    (`_pack_sphere_table` :1203) when every texture slot of their
    material is solid. The JAX package names two tests for "solid
    material" here (`_mat_solid_only` in `pallas_eligible`, no `texs` in
    `_pack_sphere_table`); they agree on every scene `slice_supported`
    takes, and the port uses the first."""
    ns = config.num_spheres
    if ns <= MAX_SPHERES:
        return np.arange(ns), np.zeros(0, np.int64)
    em = _emissive(buffers_np, buffers_np["sph_inst"][:ns])
    mats = buffers_np["inst_material"][buffers_np["sph_inst"][:ns]]
    tbl = np.array([not em[s] and accel.sphere_uniform(
        buffers_np["sph_o2w"][s])[0] and mat_solid_only(
            buffers_np, int(mats[s])) for s in range(ns)], bool)
    return np.nonzero(~tbl)[0], np.nonzero(tbl)[0]


def slice_supported(buffers_np, config: RenderConfig) -> None:
    """Raise NotImplementedError for a scene outside what the port's
    kernels carry (slices K1a-K1e and the Sobol sampler): the tests are
    `pallas_eligible`'s (:504-570) without its VMEM texel caps: path and
    volpath scenes, with or without media (the path body ignores them),
    under either sampler. What the kernels refuse, the XLA engine renders
    (ROADMAP Queue 1 item 4): `engine="auto"` picks it for such a scene,
    `engine="xla"` (`--engine xla`) for any."""
    def never(what):
        raise NotImplementedError(
            f"{what}: the path kernels do not take it; engine auto or "
            f"--engine xla renders the scene through the XLA engine "
            f"(ROADMAP Queue 1 item 4)")

    if config.integrator not in ("path", "volpath"):
        never(f"integrator {config.integrator!r}")
    if tex_kernel_desc(buffers_np,
                       int(buffers_np["background_texture"])) is None:
        never("a background texture that is no solid, imagemap, scale of "
              "those or checker of solids (K1b)")
    for m in sorted(set(buffers_np["inst_material"].tolist())):
        if mat_slot_descs(buffers_np, int(m)) is None:
            never(f"material {m} with a texture slot outside K1b's "
                  f"classes (a checker of imagemaps, a metal eta or k "
                  f"texture, a scaled opacity map)")
    texels = sum(int(buffers_np["img_width"][i])
                 * int(buffers_np["img_height"][i])
                 for i in kernel_images(buffers_np))
    if texels > MAX_ATLAS_TEXELS:
        never(f"an image atlas of {texels} texels (> {MAX_ATLAS_TEXELS})")
    imm, rest, _ = split_triangles(buffers_np, config)
    if imm.size > MAX_TRIS:
        never(f"{imm.size} emissive triangles (> {MAX_TRIS}, the cap of "
              f"K1c's immediates)")
    if rest.size > MESH_MAX_TRIS:
        never(f"a {rest.size}-triangle mesh (> {MESH_MAX_TRIS}, K1c's cap)")
    imm_s, tbl_s = split_spheres(buffers_np, config)
    if imm_s.size > MAX_SPHERES:
        never(f"{imm_s.size} emissive, textured or non-uniformly scaled "
              f"spheres (> {MAX_SPHERES}, the cap of K1d's immediates)")
    if tbl_s.size > SPH_TABLE_MAX:
        never(f"{tbl_s.size} table spheres (> {SPH_TABLE_MAX}, K1d's "
              f"cap)")
    if config.num_lights > LIGHT_TABLE_MAX:
        never(f"{config.num_lights} distant lights (> {LIGHT_TABLE_MAX}, "
              f"K1d's cap)")


def _remap_rough(r: float) -> float:
    """pbrt roughness -> alpha polynomial (pallas_path.py:608)."""
    r = max(r, 1e-3)
    x = math.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def mat_record(buffers_np, mat_idx: int) -> dict:
    """`_mat_record` (pallas_path.py:616): a material row and its
    textures as plain python floats plus per-hit descriptors.
    `rec["texs"]` maps a slot class (IMG_CLASSES) to ("checker", us, vs,
    rgb_even, rgb_odd) or ("image", img_idx, base_rgb); the plain field
    of that class then holds the base the fetched value multiplies
    (image) or a placeholder the per-hit value replaces (checker).
    `rec["rrm"]`: an imagemap roughness is remapped per hit."""
    mt = int(buffers_np["mat_type"][mat_idx])
    u0 = buffers_np["mat_u0"][mat_idx]
    u1 = buffers_np["mat_u1"][mat_idx]
    v0 = buffers_np["mat_v0"][mat_idx]
    descs = mat_slot_descs(buffers_np, mat_idx) or {}
    texs = {}

    def tex_rgb(ti):
        return tuple(float(x) for x in buffers_np["tex_v0"][int(ti), :3])

    rec = {"mat_type": mt, "albedo": (0.0, 0.0, 0.0),
           "eta": (1.0, 1.0, 1.0), "k": (0.0, 0.0, 0.0),
           "alpha": (0.0, 0.0), "ir": 1.5, "texs": texs, "rrm": 0,
           "op": (0.0, 0.0, 0.0), "kr2": (0.0, 0.0, 0.0),
           "kt2": (0.0, 0.0, 0.0), "fscale": (1.0, 1.0, 1.0)}

    def slot_rgb(ti, cls):
        d = descs.get(cls)
        if d is None:
            return tex_rgb(ti)
        texs[cls] = d
        return d[3] if d[0] == "checker" else d[2]

    def slot_rough(ti, cls, remap):
        # checker values are remapped here; an image's remap waits for
        # the hit (rec["rrm"])
        d = descs.get(cls)
        if d is None:
            r = tex_rgb(ti)[0]
            return _remap_rough(r) if remap else r
        if d[0] == "checker":
            if remap:
                d = (d[0], d[1], d[2], (_remap_rough(d[3][0]),) * 3,
                     (_remap_rough(d[4][0]),) * 3)
            texs[cls] = d
            return d[3][0]
        texs[cls] = d
        if remap:
            rec["rrm"] = 1
        return float(d[2][0])

    if mt in (T.MAT_MATTE, T.MAT_MIRROR):
        rec["albedo"] = slot_rgb(u0[0], "kd")
    elif mt == T.MAT_GLASS:
        rec["ir"] = float(v0[0])
    elif mt == T.MAT_SUBSTRATE:
        rec["albedo"] = slot_rgb(u0[0], "kd")
        rec["k"] = slot_rgb(u0[1], "ks")
        remap = bool(int(u1[0]))
        rec["alpha"] = (slot_rough(u0[2], "ru", remap),
                        slot_rough(u0[3], "rv", remap))
    elif mt == T.MAT_METAL:
        rec["eta"] = tex_rgb(u0[0])
        rec["k"] = tex_rgb(u0[1])
        rec["fscale"] = tuple(1.0 if float(v) == 0.0 else float(v)
                              for v in v0[:3])
        remap = bool(int(u1[0]))
        rec["alpha"] = (slot_rough(u0[2], "ru", remap),
                        slot_rough(u0[3], "rv", remap))
        rec["albedo"] = rec["k"]
    elif mt == T.MAT_PLASTIC:
        rec["albedo"] = slot_rgb(u0[0], "kd")
        rec["k"] = slot_rgb(u0[1], "ks")
        if "rp" in descs:
            descs["ru"] = descs["rv"] = descs["rp"]
        remap = bool(int(u1[2]))
        rec["alpha"] = (slot_rough(u0[3], "ru", remap),
                        slot_rough(u0[3], "rv", remap))
    elif mt == T.MAT_UBER:
        rec["albedo"] = slot_rgb(u0[0], "kd")
        rec["k"] = slot_rgb(u0[1], "ks")
        kr = slot_rgb(u0[2], "kr")
        kt = slot_rgb(u0[3], "kt")
        op_desc = descs.get("op")
        if op_desc is None:
            op = tex_rgb(u1[0])
            rec["op"] = tuple(1.0 - c for c in op)
            rec["kr2"] = tuple(op[i] * kr[i] for i in range(3))
            rec["kt2"] = tuple(op[i] * kt[i] for i in range(3))
            # a solid opacity folds into textured Kr / Kt
            for cls in ("kr", "kt"):
                d = texs.get(cls)
                if d is None:
                    continue
                if d[0] == "checker":
                    texs[cls] = (d[0], d[1], d[2],
                                 tuple(op[i] * d[3][i] for i in range(3)),
                                 tuple(op[i] * d[4][i] for i in range(3)))
                else:
                    texs[cls] = (d[0], d[1],
                                 tuple(op[i] * d[2][i] for i in range(3)))
        else:
            # textured opacity: kr2 / kt2 hold the products without it;
            # the per-hit value multiplies them and sets op = 1 - v
            texs["op"] = op_desc
            rec["kr2"] = tuple(kr)
            rec["kt2"] = tuple(kt)
        rec["ir"] = float(v0[0])
        remap = bool(int(u1[1]))
        rec["alpha"] = (slot_rough(u1[2], "ru", remap),
                        slot_rough(u1[3], "rv", remap))
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
            "uv0": tuple(float(x) for x in buffers_np["tri_uv"][i][0]),
            "uv1": tuple(float(x) for x in buffers_np["tri_uv"][i][1]),
            "uv2": tuple(float(x) for x in buffers_np["tri_uv"][i][2]),
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


def _background(buffers_np, offsets) -> dict:
    """The miss radiance as `pack_scene` splits it (:1538-1553): `color`
    the constant (background_color x a solid texture or an image's scale
    base), `kind` BG_CONST / BG_IMAGE / BG_CHECKER with the image's
    (texel offset, w, h) or the checker's (us, vs, even rgb, odd rgb).
    `offsets` maps an image id to its first texel of the atlas."""
    desc = tex_kernel_desc(buffers_np, int(buffers_np["background_texture"]))
    color = tuple(float(x) for x in buffers_np["background_color"])
    out = {"kind": BG_CONST, "img": (0, 0, 0), "chk": (0.0,) * 8}
    if desc[0] == "image":
        ii, base = desc[1], desc[2]
        out.update(kind=BG_IMAGE, img=(
            offsets[ii], int(buffers_np["img_width"][ii]),
            int(buffers_np["img_height"][ii])))
        color = tuple(color[i] * base[i] for i in range(3))
    elif desc[0] == "checker":
        out.update(kind=BG_CHECKER,
                   chk=(desc[1], desc[2], *desc[3], *desc[4]))
    else:
        color = tuple(float(desc[1][i] * color[i]) for i in range(3))
    out["color"] = color
    return out


def pack_atlas(buffers_np):
    """(atlas, offsets): the images the kernel fetches, back to back as
    RGB9E5 words (uint32, at least one word), and each image id's first
    texel. scene/device.py has put the texels on the RGB9E5 grid, so the
    encoding loses nothing."""
    from ..ops.rgb9e5 import encode
    parts, offsets, n = [], {}, 0
    for ii in kernel_images(buffers_np):
        cnt = int(buffers_np["img_width"][ii]) \
            * int(buffers_np["img_height"][ii])
        off = int(buffers_np["img_offset"][ii])
        offsets[ii] = n
        parts.append(encode(buffers_np["img_atlas"][off:off + cnt, :3]))
        n += cnt
    atlas = np.concatenate(parts) if parts else np.zeros(1, np.uint32)
    return np.ascontiguousarray(atlas, dtype=np.uint32), offsets


def env_guides(mcdf: np.ndarray, ccdf: np.ndarray) -> np.ndarray:
    """The (1 + rows, ENV_GUIDE) uint8 guide tables of the env-map cdfs:
    row 0 the marginal's, row 1 + r conditional row r's. Entry b is the
    first index whose float32 cdf value is >= b / ENV_GUIDE, capped at
    the last index: where x >= b / ENV_GUIDE the first cdf value >= x
    lies at or after it (csrc/texture.cuh guided_search)."""
    out = np.zeros((1 + ccdf.shape[0], ENV_GUIDE), np.uint8)
    keys = (np.arange(ENV_GUIDE) / ENV_GUIDE).astype(np.float32)
    for i, cdf in enumerate([mcdf] + list(ccdf)):
        cdf = np.asarray(cdf, np.float32)
        out[i] = np.minimum(np.searchsorted(cdf, keys, "left"),
                            cdf.shape[0] - 1)
    return out


def imm_rows(tris: np.ndarray, spheres: np.ndarray) -> np.ndarray:
    """The immediates' cast rows, flat float32: per triangle row of
    `tris` (TRI_W wide) the IMM_TRI_W floats of its plane and sides, then
    per sphere of `spheres` its IMM_SPH_W-float world-to-object matrix;
    copies of the table's values."""
    t = np.zeros((tris.shape[0], IMM_TRI_W), np.float32)
    for dst, src, n in ((IMM_PN, TRI_PN, 3), (IMM_PK, TRI_PK, 1),
                        (IMM_M0, TRI_M0, 3), (IMM_E0, TRI_E0, 3),
                        (IMM_M1, TRI_M1, 3), (IMM_E1, TRI_E1, 3),
                        (IMM_M2, TRI_M2, 3), (IMM_E2, TRI_E2, 3)):
        t[:, dst:dst + n] = tris[:, src:src + n]
    s = np.ascontiguousarray(spheres[:, SPH_W2O:SPH_W2O + IMM_SPH_W],
                             np.float32)
    return np.concatenate([t.reshape(-1), s.reshape(-1)])


def mat_row(rec: dict, offsets, buffers_np) -> np.ndarray:
    """A material record as its MAT_W-wide table row (float64)."""
    row = np.zeros(MAT_W, np.float64)
    row[MAT_TYPE] = rec["mat_type"]
    for key, off in (("albedo", MAT_ALBEDO), ("eta", MAT_ETA), ("k", MAT_K),
                     ("op", MAT_OP), ("kr2", MAT_KR2), ("kt2", MAT_KT2),
                     ("fscale", MAT_FSCALE)):
        row[off:off + 3] = rec[key]
    row[MAT_ALPHA:MAT_ALPHA + 2] = rec["alpha"]
    row[MAT_IR] = rec["ir"]
    row[MAT_NTEX] = len(rec["texs"])
    row[MAT_RRM] = rec["rrm"]
    prev = None   # the image of the previous image class
    for cls, d in sorted(rec["texs"].items(),
                         key=lambda kv: IMG_CLASSES.index(kv[0])):
        o = MAT_TEX + IMG_CLASSES.index(cls) * TEXD_W
        if d[0] == "checker":
            row[o + TEXD_KIND] = TEXK_CHECKER
            row[o + TEXD_US], row[o + TEXD_VS] = d[1], d[2]
            row[o + TEXD_EVEN:o + TEXD_EVEN + 3] = d[3]
            row[o + TEXD_ODD:o + TEXD_ODD + 3] = d[4]
        else:
            ii = d[1]
            row[o + TEXD_KIND] = TEXK_IMAGE
            row[o + TEXD_OFF] = offsets[ii]
            row[o + TEXD_IW] = int(buffers_np["img_width"][ii])
            row[o + TEXD_IH] = int(buffers_np["img_height"][ii])
            row[o + TEXD_SAME] = float(prev == ii)
            prev = ii
    return row


def max_depth_for(config: RenderConfig) -> int:
    """rene_tpu/integrators/path.py:52 and volpath.py:39: the scene's
    maxdepth, else 50 for path and 80 for volpath."""
    if config.max_depth_hint is not None:
        return max(int(config.max_depth_hint), 1)
    return 80 if config.integrator == "volpath" else 50


def material_slots(buffers_np):
    """(slots, inst_slot): the material slots as (material, interior
    medium, exterior medium) triples and the slot of each instance. Slot
    m is material m between vacuum on both sides, then come the other
    triples the instances carry, sorted, as the JAX packer gives every
    unique triple its own record (:819-831, :1033, :1386, :1414). A
    scene without media interfaces keeps one slot per material, so its
    tables are those of a scene packed without slots."""
    n_mats = buffers_np["mat_type"].shape[0]
    tri = np.stack([buffers_np["inst_material"], buffers_np["inst_interior"],
                    buffers_np["inst_exterior"]], axis=1).astype(np.int64)
    iface = (tri[:, 1] != 0) | (tri[:, 2] != 0)
    extra = [tuple(int(v) for v in r) for r in np.unique(tri[iface], axis=0)]
    slot_of = {r: n_mats + k for k, r in enumerate(extra)}
    inst_slot = tri[:, 0].copy()
    for i in np.nonzero(iface)[0]:
        inst_slot[i] = slot_of[tuple(int(v) for v in tri[i])]
    return [(m, 0, 0) for m in range(n_mats)] + extra, inst_slot


def media_table(buffers_np) -> np.ndarray:
    """(K, MED_W) float64 rows of the scene's media (row 0 vacuum):
    sigma_t as the JAX kernel bakes it (`med_consts` :3287, the float64
    sum of the float32 sigma_a and sigma_s), sigma_s, g and the vacuum
    flag."""
    n = buffers_np["med_type"].shape[0]
    med = np.zeros((n, MED_W), np.float64)
    sa = buffers_np["med_sigma_a"].astype(np.float64)
    ss = buffers_np["med_sigma_s"].astype(np.float64)
    med[:, MED_ST:MED_ST + 3] = sa + ss
    med[:, MED_SS:MED_SS + 3] = ss
    med[:, MED_G] = buffers_np["med_g"].astype(np.float64)
    med[:, MED_VAC] = buffers_np["med_type"] == T.MEDIUM_VACUUM
    return med


@dataclasses.dataclass
class SceneTables:
    """Everything the path kernel reads, as numpy float32/int32. The
    acceleration tables (scene/accel.py) are empty for a scene that fits
    the immediates budget."""
    tris: np.ndarray         # (T, TRI_W) immediate triangles
    spheres: np.ndarray      # (S, SPH_W) immediate spheres
    mats: np.ndarray         # (M, MAT_W) material slots (material_slots)
    media: np.ndarray        # (K, MED_W) homogeneous media, row 0 vacuum
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
    mesh_uv: np.ndarray      # (P, MESH_UV_W) uv of the mesh rows, or (0, 6)
    wnodes: np.ndarray       # (W, WNODE_W) the CUDA walk's wide nodes
    mesh_vt: np.ndarray      # (P, VT_W) v0, e1, e2 of the mesh rows
    atlas: np.ndarray        # uint32 RGB9E5 texels, the images back to back
    imm: np.ndarray          # the immediates' cast rows (`imm_rows`)
    env_guide: np.ndarray    # (1 + ENV_GH, ENV_GUIDE) uint8, or empty
    env_mcdf: np.ndarray     # (ENV_GH,) env-map sampling tables, or empty
    env_ccdf: np.ndarray     # (ENV_GH, ENV_GW)
    env_pdf: np.ndarray      # (ENV_GH, ENV_GW)
    width: int
    height: int
    max_depth: int
    volpath: bool            # the volpath integrator
    sobol: bool              # `Sampler "sobol"`: the kernels' Sobol draws
    world_root: int          # root node of the world mesh, -1 if none
    bvh_depth: int           # deepest root-to-leaf path of any BVH
    max_leaf: int            # most triangles in one BVH leaf
    top: int                 # the CUDA walk's first entry, -1 if none
    walk_need: int           # the deepest stack that walk may need

    @property
    def has_tex(self) -> bool:
        """Some material has a textured slot: hits need their uv."""
        return bool((self.mats[:, MAT_NTEX] > 0).any())

    @property
    def bg_kind(self) -> int:
        return int(self.cam[CAM_BG_KIND])

    @property
    def has_env(self) -> bool:
        """The env map is one of the light-sampling strategies."""
        return bool(self.env_mcdf.shape[0])

    @property
    def use_rr(self) -> bool:
        """Russian roulette from depth RR_START; never in volpath
        (pallas_path.py:1656-1658)."""
        return self.max_depth > RR_START + 1 and not self.volpath

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
    """The kernels' tables of a scene, inside span `rene.tables.pack`."""
    with trace.span("rene.tables.pack"):
        return _pack_tables(buffers_np, config)


def _pack_tables(buffers_np, config: RenderConfig) -> SceneTables:
    slice_supported(buffers_np, config)
    imm, rest, shared = split_triangles(buffers_np, config)
    # the triangles that leave the immediates, as `_mesh_needs_uv` sees
    # them
    mesh_idx = np.setdiff1d(np.arange(config.num_triangles), imm)
    imm_s, tbl_s = split_spheres(buffers_np, config)
    tris, spheres, emit_objects, lights = pack_records(buffers_np, config,
                                                       imm, imm_s)
    n_mats = buffers_np["mat_type"].shape[0]
    atlas, offsets = pack_atlas(buffers_np)
    used = set(buffers_np["inst_material"].tolist())
    # a material no instance uses may hold a slot the kernel cannot
    # evaluate: it gets its plain fields and no descriptors
    recs = [mat_record(buffers_np, m) for m in range(n_mats)]
    rows = [mat_row(r if m in used else dict(r, texs={}, rrm=0), offsets,
                    buffers_np) for m, r in enumerate(recs)]
    slots, inst_slot = material_slots(buffers_np)
    mats = np.stack([rows[m] for m, _, _ in slots])
    mats[:, MAT_IMED] = [i for _, i, _ in slots]
    mats[:, MAT_EMED] = [e for _, _, e in slots]

    tt = np.zeros((len(tris), TRI_W), np.float64)
    for i, r in enumerate(tris):
        for key, off in (("m0", TRI_M0), ("e0", TRI_E0), ("m1", TRI_M1),
                         ("e1", TRI_E1), ("m2", TRI_M2), ("e2", TRI_E2),
                         ("pn", TRI_PN), ("n0", TRI_N0), ("n1", TRI_N1),
                         ("n2", TRI_N2), ("gn_unit", TRI_GN),
                         ("v0", TRI_V0), ("v1", TRI_V1), ("v2", TRI_V2)):
            tt[i, off:off + 3] = r[key]
        for key, off in (("uv0", TRI_UV0), ("uv1", TRI_UV1),
                         ("uv2", TRI_UV2)):
            tt[i, off:off + 2] = r[key]
        tt[i, TRI_PK] = r["pk"]
        tt[i, TRI_AREA] = r["area"]
        tt[i, TRI_PRIMS] = r["prim_count"]
        if r["emissive"]:
            tt[i, TRI_EMIT:TRI_EMIT + 3] = r["emit"]
        tt[i, TRI_MAT] = inst_slot[buffers_np["tri_inst"][imm[i]]]

    st = np.zeros((len(spheres), SPH_W), np.float64)
    for s, r in enumerate(spheres):
        st[s, SPH_W2O:SPH_W2O + 12] = np.asarray(r["w2o"]).reshape(-1)
        st[s, SPH_O2W:SPH_O2W + 12] = np.asarray(r["o2w"]).reshape(-1)
        if r["emissive"]:
            st[s, SPH_EMIT:SPH_EMIT + 3] = r["emit"]
        st[s, SPH_MAT] = inst_slot[buffers_np["sph_inst"][imm_s[s]]]
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
    bg = _background(buffers_np, offsets)
    cam[CAM_BG:CAM_BG + 3] = bg["color"]
    cam[CAM_BG_KIND] = bg["kind"]
    cam[CAM_BG_IMG:CAM_BG_IMG + 3] = bg["img"]
    cam[CAM_BG_CHK:CAM_BG_CHK + 8] = bg["chk"]
    cam[CAM_BG_MAT:CAM_BG_MAT + 9] = np.asarray(
        buffers_np["background_matrix"], np.float64)[:3, :3].reshape(-1)
    cam[CAM_BG_INV:CAM_BG_INV + 9] = np.asarray(
        buffers_np["background_matrix_inv"], np.float64)[:3, :3].reshape(-1)
    env = bool(getattr(config, "env_nee", False)) and bg["kind"] == BG_IMAGE
    assert not env or buffers_np["env_ccdf"].shape == (ENV_GH, ENV_GW)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    mcdf = f32(buffers_np["env_mcdf"] if env else np.zeros(0))
    ccdf = f32(buffers_np["env_ccdf"] if env else np.zeros((0, ENV_GW)))
    return SceneTables(
        tris=f32(tt), spheres=f32(st), mats=f32(mats),
        imm=imm_rows(f32(tt), f32(st)),
        env_guide=(env_guides(mcdf, ccdf) if env
                   else np.zeros((0, ENV_GUIDE), np.uint8)),
        media=f32(media_table(buffers_np)),
        emit_objects=f32(eo),
        emit_tris=np.asarray([i for i, r in enumerate(tris) if r["emissive"]],
                             np.int32),
        emit_spheres=np.asarray(
            [s for s, r in enumerate(spheres) if r["emissive"]], np.int32),
        lights=f32(lt), light_dots=f32(dots), cam=f32(cam), atlas=atlas,
        env_mcdf=mcdf, env_ccdf=ccdf,
        env_pdf=f32(buffers_np["env_pdf"] if env else np.zeros((0, ENV_GW))),
        width=w, height=h, max_depth=max_depth_for(config),
        volpath=config.integrator == "volpath",
        sobol=config.sampler == "sobol",
        **accel.pack_accel(buffers_np, rest, shared, tbl_s, inst_slot,
                           needs_uv=bool(rest.size or shared)
                           and mesh_needs_uv(buffers_np, mesh_idx)))

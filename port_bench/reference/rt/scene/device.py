"""Frozen copy of rene_tpu_torch/scene/device.py at commit ed2dcef.

Device scene: flat SoA buffers ready for the TPU render kernels.

This replaces the reference's Vulkan upload + acceleration-structure build
(rene/src/main.rs:2910-3336). TPU-first design decisions:

* Triangle geometry is pre-transformed to *world space* at compile time
  (instances replicate their mesh), removing per-ray object-space transforms
  from the hot loop. Vertex normals are transformed by the inverse-transpose
  so that `normalize(interp(n_world))` equals the reference's
  `normalize(W2O^T @ interp(n_obj))` exactly (linear maps commute with
  barycentric interpolation).
* Spheres stay analytic with per-instance affine object<->world matrices
  (the reference's unit-AABB BLAS + intersection shader).
* The reference's two TLASes (all instances vs emissive-only, main.rs:3109-3141)
  become two triangle/sphere index sets over the same buffers.
* Images are packed into one flat RGBA atlas with per-image offset/size.

Everything is float32/int32 numpy; `to_torch()` moves the buffers onto a
torch device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from . import types as T
from .flatten import FlatScene
from .intermediate import Film

# infinite-light importance-sampling grid (see build_device_scene):
# ENV_GW is one VPU register row wide and ENV_GH fits a single row too,
# so the pallas kernels can binary-search both CDFs with broadcast-row
# lane gathers (the only per-lane gather Mosaic lowers).
ENV_GH, ENV_GW = 64, 128


@dataclasses.dataclass
class RenderConfig:
    """Static (compile-time) scene facts the kernels specialize on.

    `mat_types` / `tex_types` / `max_lobes` drive scene-specialized
    compilation: kernels only emit code for the material/BxDF/texture
    variants the scene actually contains (a pure-matte scene compiles a
    Lambertian-only BSDF), the TPU analogue of shader specialization.
    """
    integrator: str
    film: Film
    num_instances: int
    num_triangles: int
    num_spheres: int
    num_emit_triangles: int
    num_emit_spheres: int
    num_lights: int
    num_emit_objects: int
    emit_primitives: int
    max_depth_hint: Optional[int] = None
    mat_types: tuple = ()
    tex_types: tuple = ()
    max_lobes: int = 5
    has_media: bool = False
    # tent (triangle) pixel-filter radius via filter importance
    # sampling; 0.0 = box jitter (the previous behavior)
    filter_radius: float = 0.0
    # "sobol": padded Owen-scrambled (0,2)-sequence draws in the pallas
    # engines (ops/sobol.py); "independent": the PRNG everywhere
    sampler: str = "independent"
    # importance-sample an imagemap infinite light inside the NEE/MIS
    # mixture (beyond the reference, which only picks the env up
    # through the miss shader — HDR window texels firefly there).
    # True iff the background texture is an imagemap (see ENV_* grid
    # buffers); RENE_ENV_NEE=0 disables.
    env_nee: bool = False


def _affine(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, dtype=np.float32)[:3, :4]


def build_device_scene(scene: FlatScene):
    """FlatScene -> (buffers: dict[str, np.ndarray], config: RenderConfig)."""
    tri_p = [np.zeros((0, 3, 3), np.float32)]
    tri_n = [np.zeros((0, 3, 3), np.float32)]
    tri_uv = [np.zeros((0, 3, 2), np.float32)]
    tri_inst = [np.zeros((0,), np.int32)]
    sph_o2w = []
    sph_w2o = []
    sph_inst = []

    inst_material = []
    inst_area_light = []
    inst_interior = []
    inst_exterior = []
    inst_prim_count = []
    inst_tri_start = []
    inst_kind = []

    emit_tri_ids = []
    emit_sph_ids = []
    # emit objects: the per-emissive-instance sampling records
    # (reference EnumSurfaceSample, surface_sample.rs)
    eo_kind = []
    eo_tri_start = []
    eo_prim_count = []
    eo_matrix = []

    inst_blas = []
    inst_o2w = []
    inst_w2o = []

    tri_count = 0
    for i, inst in enumerate(scene.tlas):
        inst_material.append(inst.material_index)
        inst_area_light.append(inst.area_light_index)
        inst_interior.append(inst.interior_medium_index)
        inst_exterior.append(inst.exterior_medium_index)
        inst_kind.append(inst.kind)
        inst_blas.append(-1 if inst.blas_index is None else inst.blas_index)
        _m = inst.matrix.astype(np.float64)
        inst_o2w.append(_affine(_m))
        inst_w2o.append(_affine(np.linalg.inv(_m)))
        emissive = scene.area_type[inst.area_light_index] != T.AREA_NULL
        if inst.kind == T.KIND_SPHERE:
            m = inst.matrix.astype(np.float64)
            sph_o2w.append(_affine(m))
            sph_w2o.append(_affine(np.linalg.inv(m)))
            sph_inst.append(i)
            inst_prim_count.append(1)
            inst_tri_start.append(0)
            if emissive:
                emit_sph_ids.append(len(sph_inst) - 1)
                eo_kind.append(T.KIND_SPHERE)
                eo_tri_start.append(0)
                eo_prim_count.append(1)
                eo_matrix.append(_affine(m))
        else:
            mesh = scene.blases[inst.blas_index]
            m = inst.matrix.astype(np.float64)
            nrm_m = np.linalg.inv(m[:3, :3]).T
            det_sign = 1.0 if np.linalg.det(m[:3, :3]) >= 0 else -1.0
            pos = mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
            nrm = mesh.normals.astype(np.float64) @ nrm_m.T
            idx = mesh.indices.reshape(-1, 3).astype(np.int64)
            ntri = len(idx)
            p = pos[idx]  # (F,3,3)
            n = nrm[idx]
            uv = mesh.uvs[idx]
            # geometric-normal fallback triangles (all vertex normals zero,
            # reference lib.rs:931-935): bake cross product with orientation
            # preserved under the world transform (det sign).
            zero_n = (np.abs(n).sum(axis=(1, 2)) == 0.0)
            if zero_n.any():
                gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
                gn = gn * det_sign
                n = np.where(zero_n[:, None, None],
                             np.broadcast_to(gn[:, None, :], n.shape), n)
            tri_p.append(p.astype(np.float32))
            tri_n.append(n.astype(np.float32))
            tri_uv.append(uv.astype(np.float32))
            tri_inst.append(np.full(ntri, i, np.int32))
            inst_prim_count.append(ntri)
            inst_tri_start.append(tri_count)
            if emissive and ntri > 0:
                emit_tri_ids.extend(range(tri_count, tri_count + ntri))
                eo_kind.append(T.KIND_TRIANGLE)
                eo_tri_start.append(tri_count)
                eo_prim_count.append(ntri)
                eo_matrix.append(_affine(np.eye(4)))
            tri_count += ntri

    def cat(parts, shape_tail, dtype=np.float32):
        if not parts:
            return np.zeros((0,) + shape_tail, dtype)
        return np.concatenate([np.asarray(p, dtype).reshape((-1,) + shape_tail)
                               for p in parts], axis=0)

    buffers: Dict[str, np.ndarray] = {}
    buffers["tri_p"] = cat(tri_p, (3, 3))
    buffers["tri_n"] = cat(tri_n, (3, 3))
    buffers["tri_uv"] = cat(tri_uv, (3, 2))
    buffers["tri_inst"] = cat(tri_inst, (), np.int32)
    buffers["sph_o2w"] = cat(sph_o2w, (3, 4))
    buffers["sph_w2o"] = cat(sph_w2o, (3, 4))
    buffers["sph_inst"] = cat(sph_inst, (), np.int32)

    # per-instance blas identity + transforms: lets the pallas packer
    # share ONE object-space cluster table across ObjectInstance replays
    # (the reference's BLAS sharing, main.rs:2739-2908) instead of
    # paying O(instances x mesh) table memory
    buffers["inst_blas"] = np.asarray(inst_blas, np.int32)
    buffers["inst_o2w"] = cat(inst_o2w, (3, 4))
    buffers["inst_w2o"] = cat(inst_w2o, (3, 4))
    blas_vtx, blas_nrm, blas_uv, blas_idx = [], [], [], []
    blas_vtx_start, blas_idx_start = [], []
    vo = io_ = 0
    for mesh in scene.blases:
        blas_vtx_start.append(vo)
        blas_idx_start.append(io_)
        blas_vtx.append(np.asarray(mesh.positions, np.float32))
        blas_nrm.append(np.asarray(mesh.normals, np.float32))
        blas_uv.append(np.asarray(mesh.uvs, np.float32))
        blas_idx.append(np.asarray(mesh.indices, np.int32).reshape(-1))
        vo += len(mesh.positions)
        io_ += mesh.indices.size
    buffers["blas_vtx"] = cat(blas_vtx, (3,))
    buffers["blas_nrm"] = cat(blas_nrm, (3,))
    buffers["blas_uv"] = cat(blas_uv, (2,))
    buffers["blas_idx"] = cat(blas_idx, (), np.int32)
    buffers["blas_vtx_start"] = np.asarray(blas_vtx_start, np.int32)
    buffers["blas_idx_start"] = np.asarray(blas_idx_start, np.int32)

    buffers["inst_material"] = np.asarray(inst_material, np.int32)
    buffers["inst_area_light"] = np.asarray(inst_area_light, np.int32)
    buffers["inst_interior"] = np.asarray(inst_interior, np.int32)
    buffers["inst_exterior"] = np.asarray(inst_exterior, np.int32)
    buffers["inst_prim_count"] = np.asarray(inst_prim_count, np.int32)
    buffers["inst_tri_start"] = np.asarray(inst_tri_start, np.int32)
    buffers["inst_kind"] = np.asarray(inst_kind, np.int32)

    buffers["emit_tri_ids"] = np.asarray(emit_tri_ids, np.int32)
    buffers["emit_sph_ids"] = np.asarray(emit_sph_ids, np.int32)
    buffers["eo_kind"] = np.asarray(eo_kind, np.int32)
    buffers["eo_tri_start"] = np.asarray(eo_tri_start, np.int32)
    buffers["eo_prim_count"] = np.asarray(eo_prim_count, np.int32)
    buffers["eo_matrix"] = cat(eo_matrix, (3, 4))

    # material / texture / light tables
    buffers["mat_type"] = np.asarray(scene.mat_type, np.int32)
    buffers["mat_u0"] = np.asarray(scene.mat_u0, np.int32).reshape(-1, 4)
    buffers["mat_u1"] = np.asarray(scene.mat_u1, np.int32).reshape(-1, 4)
    buffers["mat_v0"] = np.asarray(scene.mat_v0, np.float32).reshape(-1, 4)
    buffers["tex_type"] = np.asarray(scene.tex_type, np.int32)
    buffers["tex_u0"] = np.asarray(scene.tex_u0, np.int32).reshape(-1, 4)
    buffers["tex_v0"] = np.asarray(scene.tex_v0, np.float32).reshape(-1, 4)
    buffers["med_type"] = np.asarray(scene.med_type, np.int32)
    buffers["med_sigma_a"] = cat(scene.med_sigma_a, (3,))
    buffers["med_sigma_s"] = cat(scene.med_sigma_s, (3,))
    buffers["med_g"] = np.asarray(scene.med_g, np.float32)
    buffers["area_type"] = np.asarray(scene.area_type, np.int32)
    buffers["area_color"] = cat(scene.area_color, (3,))
    buffers["light_dir"] = cat(scene.light_dir, (3,))
    buffers["light_color"] = cat(scene.light_color, (3,))

    # image atlas
    offsets, widths, heights, flat = [], [], [], []
    off = 0
    for img in scene.images:
        offsets.append(off)
        widths.append(img.width)
        heights.append(img.height)
        flat.append(img.data.reshape(-1, 4))
        off += img.width * img.height
    if not flat:
        offsets, widths, heights = [0], [1], [1]
        flat = [np.zeros((1, 4), np.float32)]
    atlas = np.concatenate(flat, axis=0).astype(np.float32)
    # Quantize texel RGB onto the RGB9E5 grid ONCE for both engines:
    # the kernel fetches a u32-packed atlas (one gather per bilinear
    # corner instead of three — see ops/rgb9e5.py) and decodes to
    # exactly these floats, so pallas/XLA parity stays bit-exact.
    if atlas.size:
        from ..ops.rgb9e5 import quantize
        atlas[:, :3] = quantize(atlas[:, :3])
    buffers["img_atlas"] = atlas
    buffers["img_offset"] = np.asarray(offsets, np.int32)
    buffers["img_width"] = np.asarray(widths, np.int32)
    buffers["img_height"] = np.asarray(heights, np.int32)

    # uniform (reference Uniform, rene-shader/src/lib.rs:90-102)
    buffers["camera_to_world"] = scene.camera_to_world
    buffers["camera_proj_inv"] = scene.camera_proj_inv
    buffers["background_color"] = scene.background_color
    buffers["background_matrix"] = scene.background_matrix
    buffers["background_texture"] = np.asarray(scene.background_texture,
                                               np.int32)

    # -- infinite-light importance sampling grid (ENV_GH x ENV_GW) ------
    # When the background is an imagemap, build a coarse luminance x
    # sin(theta) distribution over the latlong sphere: marginal CDF over
    # rows, conditional CDF per row, and the per-texel solid-angle pdf.
    # Sampling picks a coarse texel then a uniform point inside it, so
    # the pdf used in MIS is exactly env_pdf[r, c] — unbiased regardless
    # of how coarsely the real map was reduced (radiance is still read
    # from the full-resolution map by the miss shader). Row r covers
    # theta in [pi*r/GH, pi*(r+1)/GH] with v = 1 - theta/pi (sphere_uv)
    # and the image fetch's y = (1-v)*h flip, i.e. row 0 = zenith.
    env_nee = False
    bt = int(scene.background_texture)
    if (int(scene.tex_type[bt]) == T.TEX_IMAGEMAP
            and os.environ.get("RENE_ENV_NEE", "1") != "0"):
        img = scene.images[int(scene.tex_u0[bt][0])]
        src = np.asarray(img.data, np.float64)[..., :3]

        def resize_axis(a, n, axis):
            """Mean-reduce when the source is finer than the grid,
            replicate when coarser — per axis, so a map smaller than
            the grid in one dimension still populates EVERY grid cell
            (a half-empty grid would leave pdf~0 stripes across real
            radiance, and those directions would firefly through the
            BSDF side of the mixture)."""
            m = a.shape[axis]
            if m == n:
                return a
            a = np.moveaxis(a, axis, 0)
            if m > n:
                idx = (np.arange(m) * n) // m
                out = np.zeros((n,) + a.shape[1:], np.float64)
                np.add.at(out, idx, a)
                cnt = np.bincount(idx, minlength=n).astype(np.float64)
                out /= cnt.reshape((n,) + (1,) * (a.ndim - 1))
            else:
                out = a[(np.arange(n) * m) // n]
            return np.moveaxis(out, 0, axis)

        lum = resize_axis(resize_axis(src.mean(axis=2), ENV_GH, 0),
                          ENV_GW, 1)
        grid = lum
        th = (np.arange(ENV_GH) + 0.5) * np.pi / ENV_GH
        p = grid * np.sin(th)[:, None] + 1e-12
        p /= p.sum()
        dom = (2 * np.pi / ENV_GW) * (np.pi / ENV_GH) * np.sin(th)
        buffers["env_pdf"] = (p / dom[:, None]).astype(np.float32)
        prow = p.sum(axis=1)
        buffers["env_mcdf"] = np.cumsum(prow).astype(np.float32)
        buffers["env_ccdf"] = np.cumsum(
            p / prow[:, None], axis=1).astype(np.float32)
        m = scene.background_matrix.astype(np.float64)
        buffers["background_matrix_inv"] = np.linalg.inv(m).astype(
            np.float32)
        env_nee = True
    else:
        buffers["env_pdf"] = np.zeros((ENV_GH, ENV_GW), np.float32)
        buffers["env_mcdf"] = np.linspace(
            1.0 / ENV_GH, 1.0, ENV_GH).astype(np.float32)
        buffers["env_ccdf"] = np.tile(np.linspace(
            1.0 / ENV_GW, 1.0, ENV_GW, dtype=np.float32), (ENV_GH, 1))
        buffers["background_matrix_inv"] = np.linalg.inv(
            scene.background_matrix.astype(np.float64)).astype(np.float32)

    _mat_lobe_count = {T.MAT_NONE: 0, T.MAT_MATTE: 1, T.MAT_GLASS: 1,
                       T.MAT_SUBSTRATE: 1, T.MAT_METAL: 1, T.MAT_MIRROR: 1,
                       T.MAT_UBER: 5, T.MAT_PLASTIC: 2}
    mat_types = tuple(sorted(set(int(t) for t in scene.mat_type)))
    config = RenderConfig(
        integrator=scene.integrator,
        film=scene.film,
        mat_types=mat_types,
        tex_types=tuple(sorted(set(int(t) for t in scene.tex_type))),
        max_lobes=max([_mat_lobe_count[t] for t in mat_types] + [1]),
        has_media=any(t != T.MEDIUM_VACUUM for t in scene.med_type),
        num_instances=len(scene.tlas),
        num_triangles=int(buffers["tri_p"].shape[0]),
        num_spheres=int(buffers["sph_o2w"].shape[0]),
        num_emit_triangles=int(buffers["emit_tri_ids"].shape[0]),
        num_emit_spheres=int(buffers["emit_sph_ids"].shape[0]),
        num_lights=int(buffers["light_dir"].shape[0]),
        num_emit_objects=int(buffers["eo_kind"].shape[0]),
        emit_primitives=int(np.sum(buffers["eo_prim_count"]))
        if len(eo_kind) else 0,
        max_depth_hint=scene.max_depth_hint,
        filter_radius=(float(scene.pixel_filter[1])
                       if getattr(scene, "pixel_filter",
                                  ("box",))[0] == "triangle" else 0.0),
        sampler=getattr(scene, "sampler", "independent"),
        env_nee=env_nee,
    )

    # guarantee non-empty gatherable buffers (reference pushes dummies,
    # main.rs:2965-2975,3197-3204,3262-3299)
    def pad_nonempty(name, tail, dtype=np.float32):
        if buffers[name].shape[0] == 0:
            buffers[name] = np.zeros((1,) + tail, dtype)

    pad_nonempty("tri_p", (3, 3))
    pad_nonempty("tri_n", (3, 3))
    pad_nonempty("tri_uv", (3, 2))
    pad_nonempty("tri_inst", (), np.int32)
    pad_nonempty("sph_o2w", (3, 4))
    pad_nonempty("sph_w2o", (3, 4))
    pad_nonempty("sph_inst", (), np.int32)
    pad_nonempty("emit_tri_ids", (), np.int32)
    pad_nonempty("emit_sph_ids", (), np.int32)
    pad_nonempty("eo_kind", (), np.int32)
    pad_nonempty("eo_tri_start", (), np.int32)
    pad_nonempty("eo_prim_count", (), np.int32)
    buffers["eo_prim_count"] = np.maximum(buffers["eo_prim_count"], 1)
    pad_nonempty("eo_matrix", (3, 4))
    pad_nonempty("light_dir", (3,))
    pad_nonempty("light_color", (3,))
    for nm in ("inst_material", "inst_area_light", "inst_interior",
               "inst_exterior", "inst_prim_count", "inst_tri_start",
               "inst_kind"):
        pad_nonempty(nm, (), np.int32)

    # transposed component tables for lane-tiled gathers (see ops/vec3.py):
    # gathering rows of (K, T) along axis 1 yields (K, N) results whose
    # minor dim is the ray dim — fully utilized VPU lanes.
    buffers["tri_pT"] = np.ascontiguousarray(
        buffers["tri_p"].reshape(-1, 9).T)
    buffers["tri_nT"] = np.ascontiguousarray(
        buffers["tri_n"].reshape(-1, 9).T)
    buffers["tri_uvT"] = np.ascontiguousarray(
        buffers["tri_uv"].reshape(-1, 6).T)
    buffers["img_atlasT"] = np.ascontiguousarray(buffers["img_atlas"].T)
    buffers["tex_v0T"] = np.ascontiguousarray(buffers["tex_v0"].T)
    buffers["sph_w2oT"] = np.ascontiguousarray(
        buffers["sph_w2o"].reshape(-1, 12).T)
    buffers["sph_o2wT"] = np.ascontiguousarray(
        buffers["sph_o2w"].reshape(-1, 12).T)
    buffers["eo_matrixT"] = np.ascontiguousarray(
        buffers["eo_matrix"].reshape(-1, 12).T)

    return buffers, config


def to_torch(buffers_np: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    """The numpy buffers on `device`, unchanged (same dtypes, shapes and
    values): the counterpart of `to_jax`."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in buffers_np.items()}

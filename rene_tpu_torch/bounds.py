"""The least time the card could take for a kernel's work, on an NVIDIA
H100 SXM: the larger of the bytes it must move over the memory rate and
the operations it must do over their peak rate (NVIDIA's data sheet,
dense). chip_smoke.py's `bound_ms` and the main-path bounds of `python -m
rene_tpu_torch.probe --main-launches` come from here.

The operations of a ray cast are the tests the plain versions count for
this run's inputs (rene_tpu_torch.ops.bvh.tests, ops.intersect.casts) at
the costs in OPS; shading is not counted, so the bound is a lower one.
"""
from __future__ import annotations

import torch

HBM_BPS, FP32_OPS = 3.35e12, 67e12
# tensor-core peaks: TF32, BF16
TF32_OPS, BF16_OPS = 495e12, 989e12
# FP32 operations of one ray-cast test, counted in the plain version's
# order: the immediate triangle's plane test (its three side tests run
# only where that passes; the CUDA cast, which tests the sides first,
# keeps this bound of the same work), an immediate sphere
# (sphere_local + sphere_t), a BVH or sphere-table box (box test of
# bvh.cuh), a mesh triangle (Moeller-Trumbore) and a table sphere
OPS = {"imm_tri": 12, "imm_sph": 40, "box": 25, "tri": 50, "sph": 20}
# state rows a K2 launch moves per alive lane besides the alive row that
# every lane of the launch reads: 26 read, 23 written (wave.cuh
# wave_load, wave_store), and the medium row read and written in a
# volpath wave
K2_ROWS = 49
K2_VOL_ROWS = K2_ROWS + 2


def bound(n_bytes, ops, rate=FP32_OPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak `rate` (by default FP32's)."""
    t_b, t_o = n_bytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# the tables that only the CUDA kernels read: the walk's (scene/accel.py
# wide_tables), the env-map guide tables and the immediates' cast rows
# (scene/pack.py): the bound is that of the plain versions' work,
# whatever does it
KERNEL_ONLY = ("wnodes", "mesh_vt", "env_guide", "imm")


def table_bytes(tabs):
    return sum(v.numel() * v.element_size() for k, v in tabs.items()
               if isinstance(v, torch.Tensor) and k not in KERNEL_ONLY)


def moved_bytes(tabs, tests):
    """Bytes of the tables a launch must read: every table once (the
    plain versions': not KERNEL_ONLY), of the atlas the texels `tests` counts,
    at most the whole atlas."""
    atlas = tabs["atlas"].numel() * tabs["atlas"].element_size()
    return (table_bytes(tabs) - atlas
            + min(atlas, 4 * int(tests.get("texels", 0))))


def reset_counts():
    """Set the plain versions' ray-cast test, texel and volpath cast
    counts to 0."""
    from .ops import bvh, intersect, texture
    for k in bvh.tests:
        bvh.tests[k] = 0
    for k in intersect.casts:
        intersect.casts[k] = 0
    texture.counts["texels"] = 0


def plain_counts():
    """The plain versions' counts since reset_counts; the volpath casts
    by kind where the volpath body ran."""
    from .ops import bvh, intersect, texture
    out = dict(bvh.tests, texels=texture.counts["texels"])
    if any(intersect.casts.values()):
        out.update(intersect.casts)
    return out


def cast_ops(tabs, rays, tests):
    """FP32 operations of `rays` ray casts against the immediates, plus
    the plain walk's box, triangle and table-sphere `tests`. Where `tests`
    holds the volpath casts, those replace `rays`: each closest hit and
    march step tests every immediate, each emitter-pdf cast the emissive
    ones."""
    imm = (tabs["tris"].shape[0] * OPS["imm_tri"]
           + tabs["spheres"].shape[0] * OPS["imm_sph"])
    if "closest" in tests:
        emit = (tabs["emit_tris"].shape[0] * OPS["imm_tri"]
                + tabs["emit_spheres"].shape[0] * OPS["imm_sph"])
        casts = ((tests["closest"] + tests["march"]) * imm
                 + tests["emit_pdf"] * emit)
    else:
        casts = rays * imm
    return casts + sum(OPS[k] * tests.get(k, 0)
                       for k in ("box", "tri", "sph"))

"""Frozen copy of rene_tpu_torch/bounds.py at commit ed2dcef, without its
reset_counts and plain_counts (reference/render.py has them over the
copied plain versions), the tensor cores' peaks, moved_bytes and the
wave's state rows.

The least time the card could take for a kernel's work, on an NVIDIA
H100 SXM: the larger of the bytes it must move over the memory rate and
the operations it must do over their peak rate (NVIDIA's data sheet,
dense). The roofline metrics of the benchmark come from here.

The operations of a ray cast are the tests the plain versions count for
this run's inputs (rt.ops.bvh.tests, rt.ops.intersect.casts) at
the costs in OPS; shading is not counted, so the bound is a lower one.
"""
from __future__ import annotations

import torch

HBM_BPS, FP32_OPS = 3.35e12, 67e12
# FP32 operations of one ray-cast test, counted in the plain version's
# order: the immediate triangle's plane test (its three side tests run
# only where that passes; the CUDA cast, which tests the sides first,
# keeps this bound of the same work), an immediate sphere
# (sphere_local + sphere_t), a BVH or sphere-table box (box test of
# bvh.cuh), a mesh triangle (Moeller-Trumbore) and a table sphere
OPS = {"imm_tri": 12, "imm_sph": 40, "box": 25, "tri": 50, "sph": 20}


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 operations over their peak rate."""
    t_b, t_o = n_bytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# the tables that only the CUDA kernels read: the walk's (scene/accel.py
# wide_tables), the env-map guide tables and the immediates' cast rows
# (scene/pack.py): the bound is that of the plain versions' work,
# whatever does it
KERNEL_ONLY = ("wnodes", "mesh_vt", "env_guide", "imm")


def table_bytes(tabs):
    return sum(v.numel() * v.element_size() for k, v in tabs.items()
               if isinstance(v, torch.Tensor) and k not in KERNEL_ONLY)


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

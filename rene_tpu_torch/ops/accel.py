"""The XLA engine's accelerator, per scene (rene_tpu/ops/accel.py).

Scenes of up to MXU_MAX_TRIS triangles are cast against by the brute-
force intersector of matrix products (ops/mxu_intersect.py); larger ones
(or any with `force="bvh"`) by the BVH's per-lane stack walk (ops/bvh.py
`BVH.intersect`). The emissive set, usually a handful of triangles,
always takes the matrix products. Everything lives on `device`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MXU_MAX_TRIS = 4096


@dataclasses.dataclass
class SceneAccel:
    main: object = None        # MXUIntersector | BVH | None (spheres only)
    emit: object = None        # MXUIntersector | None


def make_accel(buffers_np, config, device, mxu_max_tris: int = MXU_MAX_TRIS,
               force: Optional[str] = None) -> SceneAccel:
    from .bvh import build_bvh
    from .mxu_intersect import MXUIntersector

    accel = SceneAccel()
    if config.num_triangles > 0:
        if force == "bvh" or (force is None
                              and config.num_triangles > mxu_max_tris):
            accel.main = build_bvh(buffers_np["tri_p"]).to_device(device)
        else:
            accel.main = MXUIntersector(buffers_np["tri_p"],
                                        device).to_device()
    if config.num_emit_triangles > 0:
        emit_tris = buffers_np["tri_p"][
            buffers_np["emit_tri_ids"][:config.num_emit_triangles]]
        accel.emit = MXUIntersector(emit_tris, device).to_device()
    return accel

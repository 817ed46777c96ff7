"""Frozen copy of rene_tpu_torch/integrators/camera.py at commit ed2dcef.

Pinhole camera rays of the megakernel (pallas_path.py:4140-4161).

`cam` is the scene's camera row (`SceneTables.cam`) as python floats;
every constant is the float32 value the JAX kernel bakes in.

`filter_jitter` and `generate_rays` are the XLA engine's camera
(rene_tpu/integrators/camera.py): two PCG32si draws per ray, the jittered
NDC point through the inverse projection (no perspective divide) and the
camera-to-world map.
"""
from __future__ import annotations

import torch

from ..ops import rng
from ..ops.gather import host_values
from ..ops.vec3 import V3, normalize3
from ..scene import pack as P


def fjit(u, radius: float):
    """Tent pixel filter by importance sampling; radius 0 = box jitter."""
    if not radius:
        return u
    half = torch.minimum(u, 1.0 - u)
    mag = 1.0 - torch.sqrt(torch.clamp_min(2.0 * half, 0.0))
    return 0.5 + radius * torch.where(u < 0.5, -mag, mag)


def camera_ray(cam, pxf, pyf, ju, jv):
    """Unit world direction through pixel (pxf, pyf) jittered by (ju, jv);
    the origin is the camera position cam[CAM_ORIGIN:+3]."""
    r = cam[P.CAM_FILTER]
    u = (pxf + fjit(ju, r)) * cam[P.CAM_INV_W1]
    v = (pyf + fjit(jv, r)) * cam[P.CAM_INV_H1]
    nx_ = u * 2.0 - 1.0
    ny_ = v * 2.0 - 1.0
    pi = cam[P.CAM_PINV:P.CAM_PINV + 12]
    cw = cam[P.CAM_C2W:P.CAM_C2W + 12]
    tc = [pi[4 * k] * nx_ + pi[4 * k + 1] * ny_ + pi[4 * k + 2]
          + pi[4 * k + 3] for k in range(3)]
    tw = [cw[4 * k] * tc[0] + cw[4 * k + 1] * tc[1] + cw[4 * k + 2] * tc[2]
          + cw[4 * k + 3] for k in range(3)]
    o = cam[P.CAM_ORIGIN:P.CAM_ORIGIN + 3]
    return normalize3(tw[0] - o[0], tw[1] - o[1], tw[2] - o[2])


# -- the XLA engine's camera (rene_tpu/integrators/camera.py) --------------

def filter_jitter(u, radius):
    """A uniform jitter in [0, 1) to the pixel filter's sample offset:
    the raw jitter for the box (radius 0), else the tent of that radius
    by importance sampling."""
    if not radius:
        return u
    half = torch.minimum(u, 1.0 - u)
    mag = 1.0 - torch.sqrt(torch.clamp_min(2.0 * half, 0.0))
    return 0.5 + radius * torch.where(u < 0.5, -mag, mag)


def generate_rays(buffers, config, px, py, state):
    """Camera rays through pixels (px, py), (N,) integer tensors:
    (origin V3, unit direction V3, state)."""
    w = config.film.xresolution
    h = config.film.yresolution
    ju, state = rng.next_f32(state)
    jv, state = rng.next_f32(state)
    r = getattr(config, "filter_radius", 0.0)
    ju = filter_jitter(ju, r)
    jv = filter_jitter(jv, r)
    u = (px.to(torch.float32) + ju) / float(max(w - 1, 1))
    v = (py.to(torch.float32) + jv) / float(max(h - 1, 1))

    proj = host_values(buffers["camera_proj_inv"])
    c2w = host_values(buffers["camera_to_world"])
    ndc = V3(u * 2.0 - 1.0, v * 2.0 - 1.0, torch.ones_like(u))
    # glam's transform_point3a: xyz of M @ (p, 1), no perspective divide
    tc = V3(*(proj[k][0] * ndc.x + proj[k][1] * ndc.y + proj[k][2] * ndc.z
              + proj[k][3] for k in range(3)))
    target = V3(*(c2w[k][0] * tc.x + c2w[k][1] * tc.y + c2w[k][2] * tc.z
                  + c2w[k][3] for k in range(3)))
    origin = V3(*(torch.full_like(u, c2w[k][3]) for k in range(3)))
    direction = (target - origin).normalized()
    return origin, direction, state

"""Pinhole camera rays of the megakernel (pallas_path.py:4140-4161).

`cam` is the scene's camera row (`SceneTables.cam`) as python floats;
every constant is the float32 value the JAX kernel bakes in.
"""
from __future__ import annotations

import torch

from ..ops.vec3 import normalize3
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

"""Shapes of the benchmark's scenes as pbrt text.

Frozen copy of the helpers of rene_tpu_torch/scenes.py at commit ed2dcef
(`_quad`, `_block`).
"""
from __future__ import annotations

import math

import numpy as np


def _quad(p):
    pts = " ".join(f"{v:.6f}" for v in np.asarray(p, np.float64).reshape(-1))
    return ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            f'"point P" [{pts}]')


def _block(center, half, angle_deg):
    """Five faces (no bottom) of a box rotated about +y, as quads."""
    cx, cy, cz = center
    hx, hy, hz = half
    a = math.radians(angle_deg)
    rot = np.array([[math.cos(a), 0.0, math.sin(a)],
                    [0.0, 1.0, 0.0],
                    [-math.sin(a), 0.0, math.cos(a)]])

    def v(sx, sy, sz):
        return rot @ np.array([sx * hx, sy * hy, sz * hz]) + (cx, cy, cz)

    faces = [
        [v(-1, 1, -1), v(-1, 1, 1), v(1, 1, 1), v(1, 1, -1)],      # top
        [v(-1, -1, 1), v(1, -1, 1), v(1, 1, 1), v(-1, 1, 1)],      # +z
        [v(1, -1, -1), v(-1, -1, -1), v(-1, 1, -1), v(1, 1, -1)],  # -z
        [v(1, -1, 1), v(1, -1, -1), v(1, 1, -1), v(1, 1, 1)],      # +x
        [v(-1, -1, -1), v(-1, -1, 1), v(-1, 1, 1), v(-1, 1, -1)],  # -x
    ]
    return "\n".join(_quad(f) for f in faces)

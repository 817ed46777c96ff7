"""The Cornell smoke scene of Shirley, Black and Hollasch, *Ray Tracing: The
Next Week* (v4), section "Volumes", `cornell_smoke()`, in the book's own
coordinates: a 555-unit box of matte red (x = 0), green (x = 555) and
white (floor, ceiling, back) walls; a 330x305 ceiling light of radiance 7
facing down; and the two classic blocks as constant-density media of
density 0.01 bounded by `Material "none"` triangles, the tall one black
smoke (a pure absorber) and the short one white smoke (a pure scatterer),
both with the book's isotropic phase. The camera of the book: from (278,
278, -800) toward (278, 278, 0), 40 degrees; volpath to depth 50, no
background light.

The book's `rotate_y(θ)` is pbrt's `Rotate θ 0 1 0`, and a block is
rotated before it is translated, so pbrt's transform lists the
translation first. The blocks stand LIFT above the floor (see there).
"""
from __future__ import annotations

import numpy as np

from .shapes import _quad

# each block: its medium, its size, its rotation about +y (degrees) and
# its translation
BLOCKS = (("black", (165, 330, 165), 15, (265, 0, 295)),
          ("white", (165, 165, 165), -18, (130, 0, 65)))
DENSITY = 0.01
# the blocks stand this far above the floor, where the book's sit on it: a
# None face in the floor's plane ties with the floor at every crossing,
# and a ray whose cast takes the face first starts its next cast on the
# floor and leaves the box through it (the cast's tmin is 1e-3)
LIFT = 0.01


def _quad_of(q, u, v):
    """The book's quad(Q, u, v): corners Q, Q + u, Q + u + v, Q + v."""
    q, u, v = (np.asarray(a, np.float64) for a in (q, u, v))
    return _quad([q, q + u, q + u + v, q + v])


def _box_mesh(size):
    """The box (0, 0, 0)-(size) as one triangle mesh of 12 triangles, each
    wound so that its normal, cross(p1 - p0, p2 - p0), points out of the
    box: the side a crossing ray enters the exterior medium by."""
    s = np.asarray(size, np.float64)
    corner = np.array([[(i >> a) & 1 for a in range(3)] for i in range(8)],
                      np.float64) * s
    centre = s / 2
    idx = []
    for axis in range(3):
        for side in (0, 1):
            ids = [i for i in range(8) if (i >> axis) & 1 == side]
            # the face's four corners in a cycle: 0, 1, 3, 2 of those
            a, b, d, c = ids
            quad = [a, b, c, d]
            p = corner[quad]
            n = np.cross(p[1] - p[0], p[2] - p[0])
            if np.dot(n, p.mean(0) - centre) < 0:
                quad = quad[::-1]
            idx += [quad[0], quad[1], quad[2], quad[0], quad[2], quad[3]]
    pts = " ".join(f"{v:.6f}" for v in corner.reshape(-1))
    return ('Shape "trianglemesh" "integer indices" '
            f'[{" ".join(map(str, idx))}] "point P" [{pts}]')


def _block(medium, size, angle, move):
    tx, ty, tz = move
    return f"""AttributeBegin
  MediumInterface "{medium}" ""
  Material "none"
  Translate {tx} {ty + LIFT} {tz}
  Rotate {angle} 0 1 0
  {_box_mesh(size)}
AttributeEnd"""


def scene(width: int = 600, height: int = 600) -> str:
    media = "\n".join(
        f'MakeNamedMedium "{name}" "string type" "homogeneous"\n'
        f'  "rgb sigma_a" [ {a} {a} {a} ] "rgb sigma_s" [ {s} {s} {s} ] '
        f'"float g" [ 0 ]'
        for name, a, s in (("black", DENSITY, 0), ("white", 0, DENSITY)))
    blocks = "\n".join(_block(*b) for b in BLOCKS)
    return f"""
LookAt 278 278 -800  278 278 0  0 1 0
Camera "perspective" "float fov" [ 40 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "cornell_smoke.png"
Integrator "volpath" "integer maxdepth" [ 50 ]
WorldBegin
{media}
Material "matte" "rgb Kd" [ .12 .45 .15 ]
{_quad_of((555, 0, 0), (0, 555, 0), (0, 0, 555))}
Material "matte" "rgb Kd" [ .65 .05 .05 ]
{_quad_of((0, 0, 0), (0, 555, 0), (0, 0, 555))}
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 7 7 7 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  {_quad_of((113, 554, 127), (330, 0, 0), (0, 0, 305))}
AttributeEnd
Material "matte" "rgb Kd" [ .73 .73 .73 ]
{_quad_of((0, 555, 0), (555, 0, 0), (0, 0, 555))}
{_quad_of((0, 0, 0), (555, 0, 0), (0, 0, 555))}
{_quad_of((0, 0, 555), (555, 0, 0), (0, 555, 0))}
{blocks}
WorldEnd
"""

"""Inline pbrt-v3 scenes for the port's tests and its GPU smoke run.

Neither needs a sample-scene directory: every scene here is pbrt text
built from numbers, so a checkout alone can render it.

* `cornell_box(w, h)`: a Cornell box in the layout of rene's `cornell-box`
  sample (matte red/green/white walls, a short and a tall block, a
  downward-facing ceiling area light). The floor, ceiling, back and side
  walls meet, so every path that leaves the box goes out the open front
  toward the camera. The integrator keeps its default depth (50, with
  Russian roulette from depth 12), as the sample does.
* `materials_scene(w, h)`: every material type the path body shades (none,
  matte, glass, substrate, metal, mirror, uber, plastic), an emissive
  sphere, an emissive triangle quad, a distant light and the tent pixel
  filter, at `maxdepth 16` so Russian roulette runs.
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


def cornell_box(width: int = 1024, height: int = 1024) -> str:
    return f"""
LookAt 0 1 6.8  0 1 0  0 1 0
Camera "perspective" "float fov" [ 19.5 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "cornell.png"
WorldBegin
MakeNamedMaterial "White" "string type" [ "matte" ] "rgb Kd" [ .725 .71 .68 ]
MakeNamedMaterial "Red" "string type" [ "matte" ] "rgb Kd" [ .63 .065 .05 ]
MakeNamedMaterial "Green" "string type" [ "matte" ] "rgb Kd" [ .14 .45 .091 ]
NamedMaterial "White"
{_quad([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]])}
{_quad([[1, 1.99, 1], [-1, 1.99, 1], [-1, 1.99, -1], [1, 1.99, -1]])}
{_quad([[-1, 0, -1], [-1, 1.99, -1], [1, 1.99, -1], [1, 0, -1]])}
{_block((-0.33, 0.3, 0.37), (0.3, 0.3, 0.3), 17.0)}
{_block((0.33, 0.6, -0.29), (0.3, 0.6, 0.3), -17.0)}
NamedMaterial "Green"
{_quad([[-1, 0, 1], [-1, 1.99, 1], [-1, 1.99, -1], [-1, 0, -1]])}
NamedMaterial "Red"
{_quad([[1, 0, -1], [1, 1.99, -1], [1, 1.99, 1], [1, 0, 1]])}
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 17 12 4 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  {_quad([[-0.24, 1.98, -0.22], [0.23, 1.98, -0.22],
          [0.23, 1.98, 0.16], [-0.24, 1.98, 0.16]])}
AttributeEnd
WorldEnd
"""


def materials_scene(width: int = 128, height: int = 64) -> str:
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
PixelFilter "triangle" "float xwidth" [ 1 ] "float ywidth" [ 1 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "materials.png"
Integrator "path" "integer maxdepth" [ 16 ]
WorldBegin
LightSource "infinite" "rgb L" [ .08 .09 .12 ]
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.6 1.5 1.3 ]
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-8, 4, 0], [8, 4, 0], [8, 4, 6], [-8, 4, 6]])}
AttributeBegin
  Translate -3.4 0 0.6
  Material "glass" "float index" [ 1.5 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate -2.1 0.4 0.6
  Material "substrate" "rgb Kd" [ .5 .2 .1 ] "rgb Ks" [ .3 .3 .3 ]
    "float uroughness" [ .15 ] "float vroughness" [ .3 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate -0.7 0.2 0.6
  Material "metal" "float roughness" [ .2 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate 0.7 0.4 0.6
  Material "mirror" "rgb Kd" [ .9 .9 .9 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate 2.1 0.2 0.6
  Material "uber" "rgb Kd" [ .2 .4 .6 ] "rgb Ks" [ .2 .2 .2 ]
    "rgb Kr" [ .1 .1 .1 ] "rgb Kt" [ .1 .1 .1 ] "rgb opacity" [ .8 .8 .8 ]
    "float roughness" [ .1 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate 3.4 0.4 0.6
  Material "plastic" "rgb Kd" [ .1 .5 .2 ] "rgb Ks" [ .4 .4 .4 ]
    "float roughness" [ .05 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Translate 1.4 -1.3 0.3
  Material "none"
  Shape "sphere" "float radius" [ 0.3 ]
AttributeEnd
AttributeBegin
  Translate -1.2 -1.6 0.35
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 5 4 ]
  Shape "sphere" "float radius" [ 0.25 ]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 5 5 6 ]
  {_quad([[-1.0, 1.0, 3.0], [1.0, 1.0, 3.0], [1.0, -0.5, 3.0],
          [-1.0, -0.5, 3.0]])}
AttributeEnd
WorldEnd
"""

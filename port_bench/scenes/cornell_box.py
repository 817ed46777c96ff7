"""Bitterli's Cornell box, the `cornell-box` scene of hatoo/rene's
sample_scenes: matte red, green and white walls, a short and a tall
block, a downward-facing ceiling area light, the camera, field of view
and materials of the sample, and the integrator's defaults (path, depth
50, Russian roulette from depth 12).

Frozen copy of rene_tpu_torch/scenes.py `cornell_box` at commit ed2dcef.
"""
from __future__ import annotations

from .shapes import _block, _quad


def scene(width: int = 1024, height: int = 1024) -> str:
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

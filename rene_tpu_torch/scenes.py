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

Scenes past the immediates budget (512 triangles, 64 spheres, 16 distant
lights), for the mesh variant of the kernel:

* `mesh_materials_scene(w, h, nu, nv)`: the eight materials on eight
  smooth-shaded UV-sphere meshes (2 nu (nv - 1) triangles each, 2304 at
  the defaults), a floor and back wall, an emissive quad and one distant
  light, at `maxdepth 16`;
* `instanced_scene(w, h, n_inst, nu, nv)`: one UV-sphere mesh without
  normals (the geometric-normal fallback) replayed by `ObjectInstance`
  under rotations and scales, so it is one shared object-space mesh;
  an emissive quad, a distant light and a floor;
* `sphere_light_scene(w, h, n_spheres, n_lights, maxdepth)`: matte and
  plastic spheres on a grid (the sphere table past 64), one ellipsoid and
  one emissive sphere (both stay immediates), and a ring of distant
  lights (the light table past 16);
* `big_mesh_scene(w, h)`: the mesh main path. A vase, one smooth
  parametric surface of revolution on a 256 x 256 quad grid (131,072
  triangles, plastic), eight `ObjectInstance`s of one 4,096-triangle metal
  sphere, a glass sphere, a matte floor, an emissive quad and a distant
  light, at `maxdepth 17` and 1280x720 by default. At `maxdepth 50`
  it is a deep scene by the reference's rule for its wave engine (more
  than 512 triangles, maxdepth >= 32: rene_tpu/render.py:33).

Textured scenes (slice K1b). Each takes a directory first, writes its
images there as PFM files made with numpy from a seed, and returns pbrt
text that names them, to be loaded with that directory as its base:

* `textured_scene(dir, w, h, background)`: immediates only. A matte floor
  with an imagemap Kd, a substrate wall with imagemap Kd, Ks and
  roughness (`remaproughness`), a plastic sphere with imagemap Kd and Ks
  (the reference's kernel refuses a textured plastic roughness), an uber
  quad with an imagemap opacity and a checker Kr, a matte sphere whose Kd
  is a `scale` of an imagemap and a colour, a sphere with a checker Kd
  (spherical uv), an emissive quad and a distant light; the background a
  colour ("solid"), a checker, an env image ("image") or a `scale` of an
  env image ("scale");
* `env_scene(dir, w, h, emitter)`: an `infinite` light with a `mapname`
  whose dim map holds a small hot window, over a matte sphere and floor,
  without emitters or with an emissive quad: the two forms of the
  env-map light sampling;
* `textured_mesh_scene(dir, w, h, maxdepth)`: the textured main path, at
  the size of `big_mesh_scene`: its vase with uv from its own
  parametrisation and a 2048 x 2048 Kd imagemap, a checker floor, the
  eight instanced spheres sharing a substrate with 1024 x 1024 Kd and
  roughness imagemaps, a sphere of uber with an opacity imagemap, the
  emissive quad, and a 2048 x 1024 HDR env map with a sun a few texels
  wide. `small=True` cuts the meshes and images to test size.

Volpath scenes (slice K1e), each with a homogeneous medium "fog" (`FOG`)
inside a closed boundary of `Material "none"` with `MediumInterface
"fog" ""`, the camera outside it, and every shape inside it between fog
on both sides:

* `fog_scene(w, h)`: immediates only. The eight materials of
  `materials_scene` (the glass sphere and the None sphere among them)
  inside a fog sphere, an emissive sphere and quad, a distant light, a
  constant infinite light, at `maxdepth 8`;
* `fog_env_scene(dir, w, h)`: a matte sphere in a fog sphere under the
  HDR env map of `env_scene` (written to `dir`), with env-map light
  sampling and one emissive quad, so the volpath body picks between the
  two light samplers;
* `fog_mesh_scene(w, h, maxdepth, small)`: the volpath main path. The
  geometry and lights of `big_mesh_scene` with the vase, the ring of
  instanced balls and the glass sphere inside a 12-triangle fog box
  (x, y in [-3.2, 3.2], z in [0.001, 3.6]); the camera, the emissive quad
  and the floor stay outside. `maxdepth 64` by default, the deep
  volumetric setting of the reference's TPU runs; `small=True` cuts the
  vase to 1,152 and the ball to 600 triangles for the CPU tests;
* `nested_fog_scene(w, h, maxdepth)`: three nested None boundaries
  between four media around a matte sphere, two distant lights and an
  emissive quad, so that a march passes three surfaces and a scatter
  point queues three marches (the megakernel's march queue, K1e).

The Sobol sampler: `with_sampler(src, sampler)` puts a `Sampler`
directive (by default "sobol") at the head of any of these texts, in
place of one it has; `sobol_test_scene(w, h)` is the reference's own
Sobol test scene (tests/test_pallas.py:620-639: a matte sphere on a
floor under an emissive sphere and a constant infinite light, maxdepth
4, `Sampler "sobol"`), 16x16 there.
"""
from __future__ import annotations

import math

import numpy as np


def _quad(p):
    pts = " ".join(f"{v:.6f}" for v in np.asarray(p, np.float64).reshape(-1))
    return ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            f'"point P" [{pts}]')


def _mesh(p, idx, n=None, uv=None):
    """A trianglemesh shape from (V, 3) points, flat indices and optional
    (V, 3) normals and (V, 2) uv."""
    def nums(a):
        return " ".join(f"{v:.5f}" for v in np.asarray(a).reshape(-1))
    text = ('Shape "trianglemesh" "integer indices" ['
            + " ".join(map(str, np.asarray(idx).reshape(-1)))
            + f'] "point P" [{nums(p)}]')
    if n is not None:
        text += f' "normal N" [{nums(n)}]'
    if uv is not None:
        text += f' "float uv" [{nums(uv)}]'
    return text


def uv_sphere(nu: int, nv: int):
    """Unit UV sphere about the origin: (points, indices) with nv + 1
    latitude rings of nu points and 2 nu (nv - 1) triangles, wound so
    the geometric normal points out."""
    th = np.pi * np.arange(nv + 1) / nv
    ph = 2.0 * np.pi * np.arange(nu) / nu
    p = np.stack([np.sin(th)[:, None] * np.cos(ph)[None, :],
                  np.sin(th)[:, None] * np.sin(ph)[None, :],
                  np.cos(th)[:, None] + 0.0 * ph[None, :]], -1).reshape(-1, 3)
    idx = []
    for j in range(nv):
        for i in range(nu):
            a, b = j * nu + i, j * nu + (i + 1) % nu
            c, d = b + nu, a + nu
            if j > 0:
                idx += [a, d, b]
            if j < nv - 1:
                idx += [b, d, c]
    return p, np.asarray(idx, np.int64)


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


# the eight materials of materials_scene, as (pbrt material, sphere
# centre x, y, z, radius)
_MATS = [
    ('"glass" "float index" [ 1.5 ]', -3.4, 0.0, 0.6, 0.6),
    ('"substrate" "rgb Kd" [ .5 .2 .1 ] "rgb Ks" [ .3 .3 .3 ] '
     '"float uroughness" [ .15 ] "float vroughness" [ .3 ]',
     -2.1, 0.4, 0.6, 0.6),
    ('"metal" "float roughness" [ .2 ]', -0.7, 0.2, 0.6, 0.6),
    ('"mirror" "rgb Kd" [ .9 .9 .9 ]', 0.7, 0.4, 0.6, 0.6),
    ('"uber" "rgb Kd" [ .2 .4 .6 ] "rgb Ks" [ .2 .2 .2 ] "rgb Kr" [ .1 .1 .1 ] '
     '"rgb Kt" [ .1 .1 .1 ] "rgb opacity" [ .8 .8 .8 ] "float roughness" [ .1 ]',
     2.1, 0.2, 0.6, 0.6),
    ('"plastic" "rgb Kd" [ .1 .5 .2 ] "rgb Ks" [ .4 .4 .4 ] '
     '"float roughness" [ .05 ]', 3.4, 0.4, 0.6, 0.6),
    ('"none"', 1.4, -1.3, 0.3, 0.3),
    ('"matte" "rgb Kd" [ .7 .3 .25 ]', -1.2, -1.6, 0.35, 0.35),
]


def mesh_materials_scene(width: int = 128, height: int = 64, nu: int = 16,
                         nv: int = 10) -> str:
    p, idx = uv_sphere(nu, nv)
    balls = "\n".join(f"""AttributeBegin
  Translate {x} {y} {z}
  Scale {r} {r} {r}
  Material {mat}
  {_mesh(p, idx, p)}
AttributeEnd""" for mat, x, y, z, r in _MATS)
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
PixelFilter "triangle" "float xwidth" [ 1 ] "float ywidth" [ 1 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "mesh_materials.png"
Integrator "path" "integer maxdepth" [ 16 ]
WorldBegin
LightSource "infinite" "rgb L" [ .08 .09 .12 ]
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.6 1.5 1.3 ]
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-8, 4, 0], [8, 4, 0], [8, 4, 6], [-8, 4, 6]])}
{balls}
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 5 5 6 ]
  {_quad([[-1.0, 1.0, 3.0], [1.0, 1.0, 3.0], [1.0, -0.5, 3.0],
          [-1.0, -0.5, 3.0]])}
AttributeEnd
WorldEnd
"""


def instanced_scene(width: int = 128, height: int = 64, n_inst: int = 12,
                    nu: int = 20, nv: int = 12) -> str:
    p, idx = uv_sphere(nu, nv)
    insts = "\n".join(f"""AttributeBegin
  Translate {(k % 4) * 1.4 - 2.1:.2f} {(k // 4) * 1.4 - 1.4:.2f} 0.45
  Rotate {30.0 * k:.1f} 0 0 1
  Scale {0.36 + 0.04 * (k % 3):.2f} {0.36 + 0.04 * (k % 3):.2f} {0.36 + 0.04 * (k % 3):.2f}
  ObjectInstance "ball"
AttributeEnd""" for k in range(n_inst))
    return f"""
LookAt 0 -6 4  0 0 0  0 0 1
Camera "perspective" "float fov" [ 48 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "instanced.png"
Integrator "path" "integer maxdepth" [ 5 ]
WorldBegin
LightSource "distant" "point from" [ 2 -3 6 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.2 1.1 1.0 ]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 10 9 8 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  {_quad([[-0.8, -0.8, 4], [-0.8, 0.8, 4], [0.8, 0.8, 4], [0.8, -0.8, 4]])}
AttributeEnd
ObjectBegin "ball"
  Material "plastic" "rgb Kd" [ .7 .3 .25 ] "rgb Ks" [ .3 .3 .3 ]
    "float roughness" [ .1 ]
  {_mesh(p, idx)}
ObjectEnd
{insts}
Material "matte" "rgb Kd" [ .5 .5 .5 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
WorldEnd
"""


def sphere_light_scene(width: int = 128, height: int = 64,
                       n_spheres: int = 100, n_lights: int = 24,
                       maxdepth: int = 5) -> str:
    rng = np.random.default_rng(11)
    side = int(math.ceil(math.sqrt(n_spheres)))
    mats = ['"matte" "rgb Kd" [ .7 .3 .25 ]', '"matte" "rgb Kd" [ .25 .6 .3 ]',
            '"plastic" "rgb Kd" [ .3 .3 .65 ] "rgb Ks" [ .2 .2 .2 ] '
            '"float roughness" [ .1 ]']
    parts = []
    for i in range(n_spheres):
        x = (i % side - side / 2) * 1.8 + rng.uniform(-0.1, 0.1)
        y = (i // side - side / 2) * 1.8 + rng.uniform(-0.1, 0.1)
        r = rng.uniform(0.5, 0.8)
        parts.append(f"""AttributeBegin
  Material {mats[i % 3]}
  Translate {x:.3f} {y:.3f} {r:.3f}
  Shape "sphere" "float radius" [ {r:.3f} ]
AttributeEnd""")
    for i in range(n_lights):
        th = 2.0 * math.pi * i / n_lights
        el = 0.4 + 0.5 * rng.random()
        c = (0.12 + 0.1 * rng.random(3)) * 16.0 / max(n_lights, 16)
        parts.append(
            f'LightSource "distant" "rgb L" [ {c[0]:.4f} {c[1]:.4f} '
            f'{c[2]:.4f} ] "point from" [ {6 * math.cos(th):.3f} '
            f'{6 * math.sin(th):.3f} {6 * math.tan(el):.3f} ] '
            '"point to" [ 0 0 0 ]')
    body = "\n".join(parts)
    return f"""
LookAt 0 -6.5 2.6  0 1.5 0.4  0 0 1
Camera "perspective" "float fov" [ 62 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "sphere_light.png"
Integrator "path" "integer maxdepth" [ {maxdepth} ]
WorldBegin
LightSource "infinite" "rgb L" [ .25 .28 .33 ]
Material "matte" "rgb Kd" [ .55 .5 .45 ]
{_quad([[-12, -12, 0], [12, -12, 0], [12, 12, 0], [-12, 12, 0]])}
{body}
AttributeBegin
  Material "metal" "float roughness" [ .15 ]
  Translate 0.9 -3.2 0.5
  Scale 1.2 0.5 0.5
  Shape "sphere" "float radius" [ 1 ]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 10 8 6 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  Translate 0 0 6
  Shape "sphere" "float radius" [ 0.8 ]
AttributeEnd
WorldEnd
"""


def _vase(n: int = 256, with_uv: bool = False):
    """A surface of revolution about +z on an n x n quad grid (2 n^2
    triangles; the seam wraps), with analytic per-vertex normals. With
    `with_uv` the seam's column of vertices is doubled, so that (u, v) =
    (angle / 2 pi, height) runs 0..1 once around, and the uv come as a
    fourth value."""
    v = np.linspace(0.0, 1.0, n + 1)
    m = n + 1 if with_uv else n     # vertices per ring
    u = 2.0 * np.pi * np.arange(m) / n
    rad = 0.35 + 0.45 * np.sin(np.pi * (0.15 + 0.85 * v)) ** 2 \
        + 0.03 * np.sin(9.0 * np.pi * v)
    drad = (0.45 * 2.0 * np.sin(np.pi * (0.15 + 0.85 * v))
            * np.cos(np.pi * (0.15 + 0.85 * v)) * np.pi * 0.85
            + 0.03 * 9.0 * np.pi * np.cos(9.0 * np.pi * v))
    height = 2.4
    cu, su = np.cos(u)[None, :], np.sin(u)[None, :]
    p = np.stack([rad[:, None] * cu, rad[:, None] * su,
                  height * v[:, None] + 0.0 * cu], -1).reshape(-1, 3)
    # normal of (r(v) cos u, r(v) sin u, h v): (h cos u, h sin u, -r'(v))
    nrm = np.stack([height * cu + 0.0 * drad[:, None],
                    height * su + 0.0 * drad[:, None],
                    -drad[:, None] + 0.0 * cu], -1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = j * m + i
    b = j * m + (i + 1) % m
    c, d = b + m, a + m
    idx = np.stack([a, b, c, a, c, d], -1).reshape(-1)
    if not with_uv:
        return p, idx, nrm
    uv = np.stack([np.arange(m)[None, :] / n + 0.0 * v[:, None],
                   v[:, None] + 0.0 * u[None, :]], -1).reshape(-1, 2)
    return p, idx, nrm, uv


def big_mesh_scene(width: int = 1280, height: int = 720,
                   maxdepth: int = 17) -> str:
    vp, vidx, vn = _vase(256)
    sp, sidx = uv_sphere(64, 33)
    insts = "\n".join(f"""AttributeBegin
  Translate {2.2 * math.cos(a):.4f} {2.2 * math.sin(a):.4f} 0.35
  Rotate {math.degrees(a):.2f} 0 0 1
  Scale 0.35 0.35 0.35
  ObjectInstance "ball"
AttributeEnd""" for a in (2.0 * math.pi * k / 8 + 0.3 for k in range(8)))
    return f"""
LookAt 0.5 -6.5 3.2  0 0 1.0  0 0 1
Camera "perspective" "float fov" [ 38 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "big_mesh.png"
Integrator "path" "integer maxdepth" [ {maxdepth} ]
WorldBegin
LightSource "infinite" "rgb L" [ .1 .11 .14 ]
LightSource "distant" "point from" [ -3 -2 6 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.5 1.4 1.25 ]
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 6 7 ]
  {_quad([[-1.2, -1.0, 4.5], [-1.2, 1.0, 4.5], [1.2, 1.0, 4.5],
          [1.2, -1.0, 4.5]])}
AttributeEnd
Material "matte" "rgb Kd" [ .6 .58 .55 ]
{_quad([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]])}
AttributeBegin
  Material "plastic" "rgb Kd" [ .55 .25 .12 ] "rgb Ks" [ .35 .35 .35 ]
    "float roughness" [ .08 ]
  {_mesh(vp, vidx, vn)}
AttributeEnd
ObjectBegin "ball"
  Material "metal" "float roughness" [ .12 ]
  {_mesh(sp, sidx, sp)}
ObjectEnd
{insts}
AttributeBegin
  Material "glass" "float index" [ 1.5 ]
  Translate 1.3 -1.6 0.5
  Shape "sphere" "float radius" [ 0.5 ]
AttributeEnd
WorldEnd
"""


# -- textured scenes (K1b) ----------------------------------------------------
def _image(rng, h, w, lo=0.05, hi=0.9, cell=4, mono=False):
    """An (h, w, 3) float32 image: seeded random cells of `cell` texels
    with a finer random grain, in [lo, hi]."""
    ch = 1 if mono else 3
    coarse = rng.uniform(lo, hi, (-(-h // cell), -(-w // cell), ch))
    img = np.kron(coarse, np.ones((cell, cell, 1)))[:h, :w]
    img = img * rng.uniform(0.85, 1.0, (h, w, ch))
    return np.broadcast_to(img, (h, w, 3)).astype(np.float32)


def _save(directory, name, img):
    import os

    from .scene.assets.images import save_pfm
    save_pfm(os.path.join(str(directory), name), img)


def _env_image(rng, h, w, sun=(0.22, 0.3), sun_px=3, sun_rgb=(900, 800, 600)):
    """A dim sky with a gradient and a sun of `sun_px` x `sun_px` texels at
    the fractional (row, column) `sun`."""
    rows = np.linspace(0.35, 0.08, h)[:, None, None]
    img = rows * np.array([0.7, 0.85, 1.0]) * rng.uniform(0.9, 1.0, (h, w, 1))
    r0, c0 = int(sun[0] * h), int(sun[1] * w)
    img[r0:r0 + sun_px, c0:c0 + sun_px] = sun_rgb
    return img.astype(np.float32)


BACKGROUNDS = ("solid", "checker", "image", "scale")


def _background(directory, kind, rng):
    if kind == "solid":
        return 'LightSource "infinite" "rgb L" [ .3 .33 .4 ]'
    if kind == "checker":
        return ('Texture "sky" "spectrum" "checkerboard" "float uscale" [ 8 ] '
                '"float vscale" [ 4 ] "rgb tex1" [ .7 .6 .3 ] '
                '"rgb tex2" [ .1 .2 .5 ]\n'
                'LightSource "infinite" "texture L" [ "sky" ]')
    if kind not in BACKGROUNDS:
        raise ValueError(f"background {kind!r}: one of {BACKGROUNDS}")
    _save(directory, "t_env.pfm", _env_image(rng, 16, 32, sun_px=2,
                                           sun_rgb=(20, 16, 10)))
    if kind == "image":
        return ('LightSource "infinite" "rgb L" [ 1 .9 .8 ] '
                '"string mapname" "t_env.pfm"')
    return ('Texture "envmap" "spectrum" "imagemap" "string filename" '
            '"t_env.pfm"\n'
            'Texture "sky" "spectrum" "scale" "texture tex1" "envmap" '
            '"rgb tex2" [ .8 .7 1.1 ]\n'
            'LightSource "infinite" "texture L" [ "sky" ]')


def _uv_quad(p):
    return _quad(p) + ' "float uv" [ 0 0  1 0  1 1  0 1 ]'


def textured_scene(directory, width: int = 128, height: int = 64,
                   background: str = "solid", seed: int = 5) -> str:
    rng = np.random.default_rng(seed)
    for name, (h, w), kw in (
            ("t_floor.pfm", (16, 32), {}), ("t_wall_kd.pfm", (8, 16), {}),
            ("t_wall_ks.pfm", (8, 8), {"lo": 0.05, "hi": 0.4}),
            ("t_ball_kd.pfm", (16, 16), {}),
            ("t_ball_ks.pfm", (8, 8), {"lo": 0.1, "hi": 0.5}),
            ("t_rough.pfm", (8, 8), {"lo": 0.02, "hi": 0.6, "mono": True,
                                   "cell": 2}),
            ("t_opacity.pfm", (8, 8), {"lo": 0.2, "hi": 1.0, "mono": True,
                                     "cell": 2}),
            ("t_scaled.pfm", (8, 16), {})):
        _save(directory, name, _image(rng, h, w, **kw))
    return f"""
LookAt 0 -7 2.6  0 0 0.7  0 0 1
Camera "perspective" "float fov" [ 44 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "textured.png"
Integrator "path" "integer maxdepth" [ 8 ]
WorldBegin
{_background(directory, background, rng)}
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.2 1.1 1.0 ]
Texture "floor" "spectrum" "imagemap" "string filename" "t_floor.pfm"
Texture "wall_kd" "spectrum" "imagemap" "string filename" "t_wall_kd.pfm"
Texture "wall_ks" "spectrum" "imagemap" "string filename" "t_wall_ks.pfm"
Texture "ball_kd" "spectrum" "imagemap" "string filename" "t_ball_kd.pfm"
Texture "ball_ks" "spectrum" "imagemap" "string filename" "t_ball_ks.pfm"
Texture "rough" "float" "imagemap" "string filename" "t_rough.pfm"
Texture "opacity" "spectrum" "imagemap" "string filename" "t_opacity.pfm"
Texture "img" "spectrum" "imagemap" "string filename" "t_scaled.pfm"
Texture "scaled" "spectrum" "scale" "texture tex1" "img"
  "rgb tex2" [ .9 .5 .4 ]
Texture "krcheck" "spectrum" "checkerboard" "float uscale" [ 4 ]
  "float vscale" [ 4 ] "rgb tex1" [ .5 .5 .5 ] "rgb tex2" [ .05 .05 .05 ]
Texture "kdcheck" "spectrum" "checkerboard" "float uscale" [ 8 ]
  "float vscale" [ 6 ] "rgb tex1" [ .1 .1 .1 ] "rgb tex2" [ .7 .6 .2 ]
Material "matte" "texture Kd" "floor"
{_uv_quad([[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]])}
Material "substrate" "texture Kd" "wall_kd" "texture Ks" "wall_ks"
  "texture uroughness" "rough" "texture vroughness" "rough"
  "bool remaproughness" [ "true" ]
{_uv_quad([[-6, 3.5, 0], [6, 3.5, 0], [6, 3.5, 5], [-6, 3.5, 5]])}
AttributeBegin
  Translate -2.6 0.2 0.8
  Material "plastic" "texture Kd" "ball_kd" "texture Ks" "ball_ks"
    "float roughness" [ .15 ] "bool remaproughness" [ "false" ]
  Shape "sphere" "float radius" [ 0.8 ]
AttributeEnd
AttributeBegin
  Material "uber" "rgb Kd" [ .35 .3 .2 ] "rgb Ks" [ .15 .15 .15 ]
    "texture Kr" "krcheck" "rgb Kt" [ .2 .2 .2 ]
    "texture opacity" "opacity" "float roughness" [ .2 ]
    "bool remaproughness" [ "false" ]
  {_uv_quad([[-1.2, -0.6, 0.05], [0.4, -0.6, 0.05], [0.4, 0.2, 1.9],
             [-1.2, 0.2, 1.9]])}
AttributeEnd
AttributeBegin
  Translate 1.3 0.6 0.7
  Material "matte" "texture Kd" "scaled"
  Shape "sphere" "float radius" [ 0.7 ]
AttributeEnd
AttributeBegin
  Translate 3.0 -0.3 0.6
  Rotate 35 0 1 0
  Material "matte" "texture Kd" "kdcheck"
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 6 7 ]
  {_quad([[-1.0, 1.0, 4.0], [1.0, 1.0, 4.0], [1.0, -0.5, 4.0],
          [-1.0, -0.5, 4.0]])}
AttributeEnd
WorldEnd
"""


def env_scene(directory, width: int = 24, height: int = 16,
              emitter: bool = False, seed: int = 6) -> str:
    rng = np.random.default_rng(seed)
    rgb = np.full((16, 32, 3), 0.3) * rng.uniform(0.9, 1.0, (16, 32, 1))
    rgb[2:4, 4:7] = [25.0, 12.0, 5.0]
    _save(directory, "e_env.pfm", rgb.astype(np.float32))
    quad = f"""AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 8 7 6 ]
  {_quad([[-0.6, 2.2, -0.6], [0.6, 2.2, -0.6], [0.6, 2.2, 0.6],
          [-0.6, 2.2, 0.6]])}
AttributeEnd""" if emitter else ""
    return f"""
Integrator "path" "integer maxdepth" [ 5 ]
LookAt 0 1.2 -3.2  0 0.6 0  0 1 0
Camera "perspective" "float fov" [ 45 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "env.png"
WorldBegin
LightSource "infinite" "string mapname" [ "e_env.pfm" ]
{quad}
Material "matte" "rgb Kd" [ .6 .5 .4 ]
AttributeBegin
  Translate 0 0.6 0
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
Material "matte" "rgb Kd" [ .5 .5 .5 ]
{_quad([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]])}
WorldEnd
"""


def textured_mesh_scene(directory, width: int = 1280, height: int = 720,
                        maxdepth: int = 17, small: bool = False,
                        seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    n_vase, (nu, nv) = (24, (20, 16)) if small else (256, (64, 33))
    k = 32 if small else 1          # the images' cut
    for name, (h, w), kw in (
            ("m_vase_kd.pfm", (2048 // k, 2048 // k), {"cell": 64 // k}),
            ("m_ball_kd.pfm", (1024 // k, 1024 // k), {"cell": 32 // k}),
            ("m_ball_rough.pfm", (1024 // k, 1024 // k),
             {"lo": 0.03, "hi": 0.5, "mono": True, "cell": 32 // k}),
            ("m_opacity.pfm", (512 // k, 512 // k),
             {"lo": 0.3, "hi": 1.0, "mono": True, "cell": 64 // k})):
        _save(directory, name, _image(rng, h, w, **kw))
    _save(directory, "m_env.pfm", _env_image(rng, 1024 // k, 2048 // k,
                                           sun_px=3))
    vp, vidx, vn, vuv = _vase(n_vase, with_uv=True)
    sp, sidx = uv_sphere(nu, nv)
    # the sphere's own parametrisation as its uv (the seam's triangles
    # wrap back through the image)
    suv = np.stack([(np.arange(sp.shape[0]) % nu) / nu,
                    (np.arange(sp.shape[0]) // nu) / nv], -1)
    insts = "\n".join(f"""AttributeBegin
  Translate {2.2 * math.cos(a):.4f} {2.2 * math.sin(a):.4f} 0.35
  Rotate {math.degrees(a):.2f} 0 0 1
  Scale 0.35 0.35 0.35
  ObjectInstance "ball"
AttributeEnd""" for a in (2.0 * math.pi * k_ / 8 + 0.3 for k_ in range(8)))
    return f"""
LookAt 0.5 -6.5 3.2  0 0 1.0  0 0 1
Camera "perspective" "float fov" [ 38 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "textured_mesh.png"
Integrator "path" "integer maxdepth" [ {maxdepth} ]
WorldBegin
Rotate 90 1 0 0
LightSource "infinite" "rgb L" [ 1 1 1 ] "string mapname" [ "m_env.pfm" ]
Rotate -90 1 0 0
Texture "vase_kd" "spectrum" "imagemap" "string filename" "m_vase_kd.pfm"
Texture "ball_kd" "spectrum" "imagemap" "string filename" "m_ball_kd.pfm"
Texture "ball_rough" "float" "imagemap" "string filename" "m_ball_rough.pfm"
Texture "opacity" "spectrum" "imagemap" "string filename" "m_opacity.pfm"
Texture "floor" "spectrum" "checkerboard" "float uscale" [ 24 ]
  "float vscale" [ 24 ] "rgb tex1" [ .6 .58 .55 ] "rgb tex2" [ .2 .2 .22 ]
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 6 7 ]
  {_quad([[-1.2, -1.0, 4.5], [-1.2, 1.0, 4.5], [1.2, 1.0, 4.5],
          [1.2, -1.0, 4.5]])}
AttributeEnd
Material "matte" "texture Kd" "floor"
{_uv_quad([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]])}
AttributeBegin
  Material "plastic" "texture Kd" "vase_kd" "rgb Ks" [ .35 .35 .35 ]
    "float roughness" [ .08 ]
  {_mesh(vp, vidx, vn, vuv)}
AttributeEnd
ObjectBegin "ball"
  Material "substrate" "texture Kd" "ball_kd" "rgb Ks" [ .3 .3 .3 ]
    "texture uroughness" "ball_rough" "texture vroughness" "ball_rough"
    "bool remaproughness" [ "true" ]
  {_mesh(sp, sidx, sp, suv)}
ObjectEnd
{insts}
AttributeBegin
  Material "uber" "rgb Kd" [ .3 .4 .6 ] "rgb Ks" [ .2 .2 .2 ]
    "rgb Kr" [ .1 .1 .1 ] "rgb Kt" [ .3 .3 .3 ] "texture opacity" "opacity"
    "float roughness" [ .1 ]
  Translate 1.3 -1.6 0.5
  Shape "sphere" "float radius" [ 0.5 ]
AttributeEnd
WorldEnd
"""


# -- volpath scenes (K1e) -----------------------------------------------------
FOG = ('MakeNamedMedium "fog" "string type" "homogeneous" '
       '"rgb sigma_a" [ .02 .025 .03 ] "rgb sigma_s" [ .16 .14 .12 ] '
       '"float g" [ 0.3 ]')


def _box(lo, hi):
    """The 12 triangles of an axis-aligned box, wound so that every face's
    normal points out."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    faces = [[(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],  # -z
             [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],  # +z
             [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],  # -y
             [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],  # +y
             [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],  # -x
             [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)]]  # +x
    p = np.asarray(faces, np.float64).reshape(-1, 3)
    idx = np.concatenate([np.array([0, 1, 2, 0, 2, 3]) + 4 * f
                          for f in range(6)])
    return _mesh(p, idx)


def fog_scene(width: int = 128, height: int = 64) -> str:
    balls = "\n".join(f"""AttributeBegin
  Translate {x} {y} {z}
  Material {mat}
  Shape "sphere" "float radius" [ {r} ]
AttributeEnd""" for mat, x, y, z, r in _MATS)
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "fog.png"
Integrator "volpath" "integer maxdepth" [ 8 ]
WorldBegin
LightSource "infinite" "rgb L" [ .08 .09 .12 ]
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.6 1.5 1.3 ]
{FOG}
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-8, 4, 0], [8, 4, 0], [8, 4, 6], [-8, 4, 6]])}
AttributeBegin
  MediumInterface "fog" ""
  Material "none"
  Translate 0 0.2 0.6
  Shape "sphere" "float radius" [ 4.3 ]
AttributeEnd
AttributeBegin
MediumInterface "fog" "fog"
{balls}
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
AttributeEnd
WorldEnd
"""


def fog_env_scene(directory, width: int = 24, height: int = 16,
                  seed: int = 6) -> str:
    rng = np.random.default_rng(seed)
    rgb = np.full((16, 32, 3), 0.3) * rng.uniform(0.9, 1.0, (16, 32, 1))
    rgb[2:4, 4:7] = [25.0, 12.0, 5.0]
    _save(directory, "f_env.pfm", rgb.astype(np.float32))
    return f"""
Integrator "volpath" "integer maxdepth" [ 5 ]
LookAt 0 1.2 -3.2  0 0.6 0  0 1 0
Camera "perspective" "float fov" [ 45 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "fog_env.png"
WorldBegin
LightSource "infinite" "string mapname" [ "f_env.pfm" ]
{FOG.replace(".16 .14 .12", ".5 .45 .4")}
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 8 7 6 ]
  {_quad([[-0.6, 2.2, -0.6], [0.6, 2.2, -0.6], [0.6, 2.2, 0.6],
          [-0.6, 2.2, 0.6]])}
AttributeEnd
AttributeBegin
  MediumInterface "fog" ""
  Material "none"
  Translate 0 0.6 0
  Shape "sphere" "float radius" [ 1.4 ]
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "matte" "rgb Kd" [ .6 .5 .4 ]
  Translate 0 0.6 0
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
Material "matte" "rgb Kd" [ .5 .5 .5 ]
{_quad([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]])}
WorldEnd
"""


def fog_mesh_scene(width: int = 1280, height: int = 720, maxdepth: int = 64,
                   small: bool = False) -> str:
    vp, vidx, vn = _vase(24 if small else 256)
    sp, sidx = uv_sphere(*((20, 16) if small else (64, 33)))
    insts = "\n".join(f"""AttributeBegin
  Translate {2.2 * math.cos(a):.4f} {2.2 * math.sin(a):.4f} 0.35
  Rotate {math.degrees(a):.2f} 0 0 1
  Scale 0.35 0.35 0.35
  ObjectInstance "ball"
AttributeEnd""" for a in (2.0 * math.pi * k / 8 + 0.3 for k in range(8)))
    return f"""
LookAt 0.5 -6.5 3.2  0 0 1.0  0 0 1
Camera "perspective" "float fov" [ 38 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "fog_mesh.png"
Integrator "volpath" "integer maxdepth" [ {maxdepth} ]
WorldBegin
LightSource "infinite" "rgb L" [ .1 .11 .14 ]
LightSource "distant" "point from" [ -3 -2 6 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.5 1.4 1.25 ]
{FOG}
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 6 7 ]
  {_quad([[-1.2, -1.0, 4.5], [-1.2, 1.0, 4.5], [1.2, 1.0, 4.5],
          [1.2, -1.0, 4.5]])}
AttributeEnd
Material "matte" "rgb Kd" [ .6 .58 .55 ]
{_quad([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]])}
AttributeBegin
  MediumInterface "fog" ""
  Material "none"
  {_box((-3.2, -3.2, 0.001), (3.2, 3.2, 3.6))}
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "plastic" "rgb Kd" [ .55 .25 .12 ] "rgb Ks" [ .35 .35 .35 ]
    "float roughness" [ .08 ]
  {_mesh(vp, vidx, vn)}
AttributeEnd
ObjectBegin "ball"
  MediumInterface "fog" "fog"
  Material "metal" "float roughness" [ .12 ]
  {_mesh(sp, sidx, sp)}
ObjectEnd
{insts}
AttributeBegin
  MediumInterface "fog" "fog"
  Material "glass" "float index" [ 1.5 ]
  Translate 1.3 -1.6 0.5
  Shape "sphere" "float radius" [ 0.5 ]
AttributeEnd
WorldEnd
"""


def nested_fog_scene(width: int = 16, height: int = 8,
                     maxdepth: int = 16) -> str:
    """Three nested closed boundaries of `Material "none"`, each a
    288-triangle sphere mesh (so the scene runs in cluster mode), between
    four media: vacuum outside, "fog", "haze", then "dense" around a matte
    sphere at the centre. A march from the centre passes three surfaces
    and switches medium at each; two distant lights and an emissive quad
    above the spheres make a scatter point queue three marches, one of
    them toward the emitter. A floor under it all."""
    p, idx = uv_sphere(16, 10)
    shells = "\n".join(f"""AttributeBegin
  MediumInterface "{inner}" "{outer}"
  Material "none"
  Translate 0 0 1.5
  Scale {r} {r} {r}
  {_mesh(p, idx, p)}
AttributeEnd""" for inner, outer, r in (("fog", "", 1.4), ("haze", "fog", 0.95),
                                        ("dense", "haze", 0.55)))
    return f"""
LookAt 0.4 -6 2.4  0 0 1.4  0 0 1
Camera "perspective" "float fov" [ 36 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "nested_fog.png"
Integrator "volpath" "integer maxdepth" [ {maxdepth} ]
WorldBegin
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.3 1.2 1.0 ]
LightSource "distant" "point from" [ 3 -1 4 ] "point to" [ 0 0 0 ]
  "rgb L" [ .5 .6 .8 ]
{FOG}
MakeNamedMedium "haze" "string type" "homogeneous"
  "rgb sigma_a" [ .01 .01 .012 ] "rgb sigma_s" [ .3 .35 .4 ] "float g" [ -0.2 ]
MakeNamedMedium "dense" "string type" "homogeneous"
  "rgb sigma_a" [ .05 .04 .03 ] "rgb sigma_s" [ 1.2 1.1 1.0 ]
  "float g" [ 0.6 ]
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 5 5 6 ]
  {_quad([[-1.0, -1.0, 3.6], [-1.0, 1.0, 3.6], [1.0, 1.0, 3.6],
          [1.0, -1.0, 3.6]])}
AttributeEnd
Material "matte" "rgb Kd" [ .55 .55 .5 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
{shells}
AttributeBegin
  MediumInterface "dense" "dense"
  Material "matte" "rgb Kd" [ .7 .3 .2 ]
  Translate 0 0 1.5
  Shape "sphere" "float radius" [ 0.25 ]
AttributeEnd
WorldEnd
"""


# the textured scenes by name: (pbrt text writer taking (directory, width,
# height), default film). The mesh scene's default is its test size.
TEXTURED = {
    **{f"tex_{b}": (lambda d, w, h, b=b: textured_scene(d, w, h, b),
                    (128, 64)) for b in BACKGROUNDS},
    "env": (lambda d, w, h: env_scene(d, w, h), (128, 64)),
    "env_emitter": (lambda d, w, h: env_scene(d, w, h, emitter=True),
                    (128, 64)),
    "textured_mesh": (lambda d, w, h: textured_mesh_scene(
        d, w, h, small=True), (64, 64)),
}


def textured(name: str, directory, width: int = 0, height: int = 0) -> str:
    """pbrt text of TEXTURED[name] at its default film or the given one,
    its images written to `directory`."""
    write, (w, h) = TEXTURED[name]
    return write(directory, width or w, height or h)


def with_sampler(src: str, sampler: str = "sobol") -> str:
    """`src` with `Sampler "<sampler>"` at its head, in place of any
    Sampler directive it has."""
    lines = [ln for ln in src.splitlines()
             if not ln.lstrip().startswith("Sampler ")]
    return f'Sampler "{sampler}"\n' + "\n".join(lines) + "\n"


def sobol_test_scene(width: int = 16, height: int = 16) -> str:
    """The reference's Sobol test scene (tests/test_pallas.py:620-639)."""
    return f"""
LookAt 0 -4 1  0 0 0.5  0 0 1
Camera "perspective" "float fov" 55
Film "image" "integer xresolution" [{width}] "integer yresolution" [{height}]
Sampler "sobol" "integer pixelsamples" [64]
Integrator "path" "integer maxdepth" 4
WorldBegin
LightSource "infinite" "rgb L" [.5 .5 .55]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 8 6]
  Material "matte" "rgb Kd" [0 0 0]
  Translate 0 0 3
  Shape "sphere" "float radius" 0.4
AttributeEnd
Material "matte" "rgb Kd" [.6 .45 .3]
Shape "sphere" "float radius" 1
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-6 6 -1.2  -6 -6 -1.2  6 -6 -1.2  6 6 -1.2]
WorldEnd"""


# -- scenes the path kernels refuse, which the XLA engine renders ------------
# (scene/pack.py `slice_supported`; `render(engine="auto")` sends them to
# the XLA engine)

def checker_metal_scene(directory, width: int = 128, height: int = 64,
                        seed: int = 8) -> str:
    """A metal whose eta is a checker of two image maps (a checker of
    image maps, and a textured metal eta: outside K1b's classes), on a
    floor whose Kd is a checker of two image maps; its images are written
    to `directory`."""
    rng = np.random.default_rng(seed)
    for name, (h, w), kw in (("c_eta_a.pfm", (8, 8), {"lo": 0.2, "hi": 0.6}),
                             ("c_eta_b.pfm", (8, 16), {"lo": 1.0,
                                                       "hi": 2.4}),
                             ("c_floor_a.pfm", (16, 16), {}),
                             ("c_floor_b.pfm", (8, 8), {"lo": 0.02,
                                                      "hi": 0.3})):
        _save(directory, name, _image(rng, h, w, **kw))
    return f"""
LookAt 0 -7 2.4  0 0 0.7  0 0 1
Camera "perspective" "float fov" [ 42 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "checker_metal.png"
Integrator "path" "integer maxdepth" [ 8 ]
WorldBegin
LightSource "infinite" "rgb L" [ .1 .11 .14 ]
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.4 1.3 1.2 ]
Texture "eta_a" "spectrum" "imagemap" "string filename" "c_eta_a.pfm"
Texture "eta_b" "spectrum" "imagemap" "string filename" "c_eta_b.pfm"
Texture "eta" "spectrum" "checkerboard" "float uscale" [ 6 ]
  "float vscale" [ 3 ] "texture tex1" "eta_a" "texture tex2" "eta_b"
Texture "floor_a" "spectrum" "imagemap" "string filename" "c_floor_a.pfm"
Texture "floor_b" "spectrum" "imagemap" "string filename" "c_floor_b.pfm"
Texture "floor" "spectrum" "checkerboard" "float uscale" [ 8 ]
  "float vscale" [ 8 ] "texture tex1" "floor_a" "texture tex2" "floor_b"
Material "matte" "texture Kd" "floor"
{_uv_quad([[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-6, 3.5, 0], [6, 3.5, 0], [6, 3.5, 5], [-6, 3.5, 5]])}
AttributeBegin
  Translate -1.4 0.2 1.0
  Material "metal" "texture eta" "eta" "rgb k" [ 3.9 2.4 2.2 ]
    "float roughness" [ .08 ]
  Shape "sphere" "float radius" [ 1.0 ]
AttributeEnd
AttributeBegin
  Material "metal" "texture eta" "eta" "rgb k" [ 2.5 2.9 3.4 ]
    "float roughness" [ .25 ]
  {_uv_quad([[0.4, -0.4, 0.05], [2.6, -0.4, 0.05], [2.6, 0.8, 2.2],
             [0.4, 0.8, 2.2]])}
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 6 6 7 ]
  {_quad([[-1.0, 1.0, 4.0], [1.0, 1.0, 4.0], [1.0, -0.5, 4.0],
          [-1.0, -0.5, 4.0]])}
AttributeEnd
WorldEnd
"""


def _grid_mesh(n: int, lo, hi, z: float) -> str:
    """An n x n grid of 2 n^2 triangles spanning [lo, hi] in x and y at
    height z, facing down."""
    t = np.linspace(0.0, 1.0, n + 1)
    gx, gy = np.meshgrid(lo[0] + (hi[0] - lo[0]) * t,
                         lo[1] + (hi[1] - lo[1]) * t)
    p = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], 1)
    idx = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            idx += [a, a + n + 2, a + 1, a, a + n + 1, a + n + 2]
    return _mesh(p, np.asarray(idx))


def emissive_grid_scene(width: int = 128, height: int = 64,
                        n: int = 17) -> str:
    """materials_scene's room lit by an emissive n x n grid: 2 n^2
    emissive triangles, 578 at n = 17 (past K1c's immediates, MAX_TRIS
    512)."""
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "grid.png"
Integrator "path" "integer maxdepth" [ 8 ]
WorldBegin
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-8, 4, 0], [8, 4, 0], [8, 4, 6], [-8, 4, 6]])}
AttributeBegin
  Translate -1.2 0.2 0.7
  Material "plastic" "rgb Kd" [ .1 .4 .2 ] "rgb Ks" [ .4 .4 .4 ]
    "float roughness" [ .1 ]
  Shape "sphere" "float radius" [ 0.7 ]
AttributeEnd
AttributeBegin
  Translate 1.2 0.4 0.7
  Material "metal" "float roughness" [ .2 ]
  Shape "sphere" "float radius" [ 0.7 ]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 4 3.8 3.4 ]
  {_grid_mesh(n, (-1.5, -1.0), (1.5, 1.5), 3.5)}
AttributeEnd
WorldEnd
"""


def _stretched_spheres(n: int) -> str:
    """n spheres of radius 0.5 scaled 1 x 2 x 1 in a 13-wide grid on the
    floor, the nearest rows in view (non-uniformly scaled, so none goes to
    K1d's sphere table)."""
    mats = ('"matte" "rgb Kd" [ .7 .3 .2 ]',
            '"plastic" "rgb Kd" [ .2 .3 .6 ] "rgb Ks" [ .3 .3 .3 ] '
            '"float roughness" [ .1 ]',
            '"matte" "rgb Kd" [ .3 .6 .3 ]')
    out = []
    for i in range(n):
        x = -7.2 + 1.2 * (i % 13)
        y = -1.5 + 2.3 * (i // 13)
        out.append(f"""AttributeBegin
  Translate {x:.2f} {y:.2f} 0.5
  Scale 1 2 1
  Material {mats[i % 3]}
  Shape "sphere" "float radius" [ 0.5 ]
AttributeEnd""")
    return "\n".join(out)


def many_spheres_scene(width: int = 128, height: int = 64,
                       n: int = 65) -> str:
    """n spheres scaled 1 x 2 x 1 under a distant light and an area
    light: 65 is one past K1d's immediates (MAX_SPHERES 64)."""
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "spheres.png"
Integrator "path" "integer maxdepth" [ 8 ]
WorldBegin
LightSource "infinite" "rgb L" [ .08 .09 .12 ]
LightSource "distant" "point from" [ -2 -3 5 ] "point to" [ 0 0 0 ]
  "rgb L" [ 1.6 1.5 1.3 ]
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
{_stretched_spheres(n)}
AttributeBegin
  Material "matte" "rgb Kd" [ 0 0 0 ]
  AreaLightSource "diffuse" "rgb L" [ 5 5 6 ]
  {_quad([[-1.0, 1.0, 3.0], [1.0, 1.0, 3.0], [1.0, -0.5, 3.0],
          [-1.0, -0.5, 3.0]])}
AttributeEnd
WorldEnd
"""


def many_lights_scene(width: int = 128, height: int = 64, n: int = 1025,
                      maxdepth: int = 8) -> str:
    """n distant lights, 1025 by default (past K1d's light cap of 1024),
    their directions spread over the upper hemisphere, over a floor, a
    wall and two spheres."""
    rng = np.random.default_rng(9)
    z = rng.uniform(0.2, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    r = np.sqrt(1.0 - z * z)
    lights = "\n".join(
        f'LightSource "distant" "point from" [ {r[i] * np.cos(phi[i]):.4f} '
        f'{r[i] * np.sin(phi[i]):.4f} {z[i]:.4f} ] "point to" [ 0 0 0 ] '
        f'"rgb L" [ .004 .0038 .0034 ]' for i in range(n))
    return f"""
LookAt 0 -7 2.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [ 42 ]
Film "image" "integer xresolution" [ {width} ]
  "integer yresolution" [ {height} ] "string filename" "lights.png"
Integrator "path" "integer maxdepth" [ {maxdepth} ]
WorldBegin
{lights}
Material "matte" "rgb Kd" [ .6 .6 .55 ]
{_quad([[-8, -8, 0], [8, -8, 0], [8, 8, 0], [-8, 8, 0]])}
Material "matte" "rgb Kd" [ .3 .35 .5 ]
{_quad([[-8, 4, 0], [8, 4, 0], [8, 4, 6], [-8, 4, 6]])}
AttributeBegin
  Translate -1.0 0.2 0.8
  Material "plastic" "rgb Kd" [ .5 .3 .1 ] "rgb Ks" [ .3 .3 .3 ]
    "float roughness" [ .1 ]
  Shape "sphere" "float radius" [ 0.8 ]
AttributeEnd
AttributeBegin
  Translate 1.2 0.4 0.6
  Material "matte" "rgb Kd" [ .2 .4 .6 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
WorldEnd
"""


def fog_spheres_scene(width: int = 128, height: int = 64,
                      n: int = 65) -> str:
    """fog_scene with `many_spheres_scene`'s n stretched spheres inside
    its fog: a volpath scene past K1d's immediates."""
    src = fog_scene(width, height).replace('"fog.png"',
                                           '"fog_spheres.png"')
    head, tail = src.rsplit("AttributeEnd\nAttributeEnd\nWorldEnd", 1)
    return (head + "AttributeEnd\n" + _stretched_spheres(n)
            + "\nAttributeEnd\nWorldEnd" + tail)


# the refused scenes by name: (writer taking (directory, width, height),
# whether it writes images). chip_smoke.py and the tests share them.
REFUSED = {
    "checker_metal": lambda d, w, h: checker_metal_scene(d, w, h),
    "emissive_grid": lambda d, w, h: emissive_grid_scene(w, h),
    "many_spheres": lambda d, w, h: many_spheres_scene(w, h),
    "many_lights": lambda d, w, h: many_lights_scene(w, h),
    "fog_spheres": lambda d, w, h: fog_spheres_scene(w, h),
}

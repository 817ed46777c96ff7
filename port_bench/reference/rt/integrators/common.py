"""Frozen copy of rene_tpu_torch/integrators/common.py at commit ed2dcef.

Light sampling of the megakernel's path body.

Counterparts in rene_tpu/integrators/pallas_path.py: `sample_emit`
(:3439-3493), the direction half of the 50/50 emitter/BSDF MIS; and the
distant-light NEE fold (`fold_lights` :2696 over `_dist_body`
:4408-4433).

The XLA engine's shared pieces follow at the end (rene_tpu/integrators/
common.py): the background's radiance, the env map's importance sampling
and its pdf, the emitter sampling and the uniform sphere direction, all
drawing from the PCG32si stream.
"""
from __future__ import annotations

import math

import torch

from ..ops import rng
from ..ops import vec3 as v3
from ..ops.bsdf import bsdf_eval
from ..ops.gather import at, host_values, take
from ..ops.intersect import TMIN, TWO_PI, shadow_any
from ..ops.texture import tex_color, to_i32
from ..ops.vec3 import V3, normalize3, onb_from_w, to_local
from ..scene import pack as P
from ..scene import types as T


def sample_emit(tabs, px_, py_, pz_, u_obj, u_prim, r, s):
    """Unit direction from (px_, py_, pz_) toward a sampled emitter point:
    u_obj picks an emit object uniformly, u_prim one of its triangles
    (uniform barycentrics from r, s), or a sphere's visible cone."""
    eo = tabs["emit_objects"]
    n_eo = eo.shape[0]
    zero = torch.zeros_like(px_)
    flip = (r + s) > 1.0
    rr_ = torch.where(flip, 1.0 - r, r)
    ss_ = torch.where(flip, 1.0 - s, s)
    w0 = 1.0 - rr_ - ss_
    eidx = torch.floor(u_obj * float(max(n_eo, 1)))
    valid = eidx < n_eo
    rows = eo[eidx.long().clamp(0, max(n_eo - 1, 0))]
    kind = rows[:, P.EO_KIND]

    # sphere emitters: a direction in the cone the sphere subtends
    sel_sph = valid & (kind == float(T.KIND_SPHERE))
    wx_ = rows[:, P.EO_CENTER] - px_
    wy_ = rows[:, P.EO_CENTER + 1] - py_
    wz_ = rows[:, P.EO_CENTER + 2] - pz_
    r2 = rows[:, P.EO_R2]
    d2 = torch.clamp_min(wx_ * wx_ + wy_ * wy_ + wz_ * wz_, 1e-12)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - r2 / d2, 0.0))
    cos_t = torch.where(d2 <= r2, 1.0 - 2.0 * r, 1.0 - r * (1.0 - cos_max))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * s
    wx_, wy_, wz_ = normalize3(wx_, wy_, wz_)
    ux, uy, uz, vx, vy, vz = onb_from_w(wx_, wy_, wz_)
    cp = torch.cos(phi) * sin_t
    sp = torch.sin(phi) * sin_t
    dirx = torch.where(sel_sph, ux * cp + vx * sp + wx_ * cos_t, zero)
    diry = torch.where(sel_sph, uy * cp + vy * sp + wy_ * cos_t, zero)
    dirz = torch.where(sel_sph, uz * cp + vz * sp + wz_ * cos_t, zero)
    if not tabs["has_tri_emitter"]:
        return dirx, diry, dirz

    # triangle emitters: a point on the picked triangle
    sel_tri = valid & (kind == float(T.KIND_TRIANGLE))
    cnt = rows[:, P.EO_COUNT]
    pidx = torch.floor(u_prim * cnt)
    sel_tri = sel_tri & (pidx < cnt)
    tris = tabs["tris"]
    ti = (rows[:, P.EO_START] + pidx).long().clamp(0, tris.shape[0] - 1)
    tr = tris[ti]
    tq = [torch.where(sel_tri, w0 * tr[:, P.TRI_V0 + k]
                      + rr_ * tr[:, P.TRI_V1 + k]
                      + ss_ * tr[:, P.TRI_V2 + k], zero) for k in range(3)]
    tdx, tdy, tdz = normalize3(tq[0] - px_, tq[1] - py_, tq[2] - pz_)
    is_dir = (dirx != 0.0) | (diry != 0.0) | (dirz != 0.0)
    return (torch.where(is_dir, dirx, tdx),
            torch.where(is_dir, diry, tdy),
            torch.where(is_dir, dirz, tdz))


def distant_lights(tabs, lights, rgb, hx, hy, hz, frame, attr, lo, alive,
                   cr, cg, cb, beckmann=False):
    """Add each distant light's unshadowed BSDF-weighted contribution to
    the radiance sums `rgb`. `lights` holds (dir xyz, color rgb) rows as
    python floats; `frame` is (u, v, n) of the shading frame and `lo` the
    local outgoing direction."""
    ux, uy, uz, vx, vy, vz, nx, ny, nz = frame
    rr_, rg_, rb_ = rgb
    zf = hx * 0.0
    for li, (ldx, ldy, ldz, lcr, lcg, lcb) in enumerate(lights):
        bdx, bdy, bdz = zf + ldx, zf + ldy, zf + ldz
        shadowed = shadow_any(tabs, li, hx, hy, hz, bdx, bdy, bdz, TMIN, 1e5,
                              skip=~alive)
        lwx, lwy, lwz = to_local(ux, uy, uz, vx, vy, vz, nx, ny, nz,
                                 bdx, bdy, bdz)
        fe_r, fe_g, fe_b, _ = bsdf_eval(attr, *lo, lwx, lwy, lwz, beckmann)
        cosl = torch.abs(ldx * nx + ldy * ny + ldz * nz)
        okl = alive & ~shadowed
        rr_ = rr_ + torch.where(okl, cr * fe_r * cosl * lcr, 0.0)
        rg_ = rg_ + torch.where(okl, cg * fe_g * cosl * lcg, 0.0)
        rb_ = rb_ + torch.where(okl, cb * fe_b * cosl * lcb, 0.0)
    return rr_, rg_, rb_


# -- the XLA engine's shared pieces (rene_tpu/integrators/common.py) -------

def _rotate(m, d: V3) -> V3:
    return V3(*(m[k][0] * d.x + m[k][1] * d.y + m[k][2] * d.z
                for k in range(3)))


def background_radiance(buffers, direction: V3, config=None) -> V3:
    """The infinite light's radiance for escaped rays (main_miss,
    lib.rs:120-139)."""
    n = direction.x.shape[0]
    d = _rotate(host_values(buffers["background_matrix"]),
                direction).normalized()
    u, v = v3.sphere_uv(d)
    tex_idx = buffers["background_texture"].expand(n)
    tex = tex_color(buffers, tex_idx, (u, v), config)
    return tex * V3(*host_values(buffers["background_color"])[:3])


def sample_background(buffers, state):
    """The imagemap infinite light importance-sampled (env_nee): a coarse
    (ENV_GH, ENV_GW) cell from the luminance x sin(theta) distribution
    (the row's marginal CDF, then its conditional one), a uniform point
    in it; returns (world direction, solid-angle pdf, state)."""
    mcdf = buffers["env_mcdf"]
    ccdf = buffers["env_ccdf"]
    gh, gw = ccdf.shape
    x1, state = rng.next_f32(state)
    x2, state = rng.next_f32(state)
    x3, state = rng.next_f32(state)
    x4, state = rng.next_f32(state)
    r = torch.clamp((mcdf[None, :] < x1[:, None]).sum(dim=1), 0, gh - 1)
    rows = take(ccdf, r, dim=0)
    c = torch.clamp((rows < x2[:, None]).sum(dim=1), 0, gw - 1)
    theta = (r.to(torch.float32) + x3) * (math.pi / gh)
    phi = (c.to(torch.float32) + x4) * (2.0 * math.pi / gw)
    st = torch.sin(theta)
    d_l = V3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
    wi = _rotate(host_values(buffers["background_matrix_inv"]), d_l)
    pdf = buffers["env_pdf"][r, c]
    return wi.normalized(), pdf, state


def background_pdf(buffers, direction: V3):
    """The solid-angle pdf that sample_background has for `direction`."""
    d = _rotate(host_values(buffers["background_matrix"]),
                direction).normalized()
    gh, gw = buffers["env_ccdf"].shape
    theta = torch.arccos(torch.clamp(d.z, -1.0, 1.0))
    phi = torch.atan2(d.y, d.x)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    r = torch.clamp(to_i32(theta * (gh / math.pi)), 0, gh - 1)
    c = torch.clamp(to_i32(phi * (gw / (2.0 * math.pi))), 0, gw - 1)
    return buffers["env_pdf"][r, c]


def sample_emit_object(buffers, config, position: V3, state):
    """A uniformly picked emissive object and a direction toward it: a
    uniform barycentric point of a uniform triangle
    (surface_sample.rs:74-105), or a uniform direction in a sphere's
    visible cone (a uniform direction where the point is inside it), the
    density trace_emissive_pdf reports."""
    e = config.num_emit_objects
    u_obj, state = rng.next_u32(state)
    eo = u_obj % max(e, 1)
    kind = at(buffers["eo_kind"], eo)
    tri_start = at(buffers["eo_tri_start"], eo).long()
    prim_count = at(buffers["eo_prim_count"], eo).long()

    u_prim, state = rng.next_u32(state)
    prim = u_prim % prim_count
    tri_id = torch.clamp(tri_start + prim, 0,
                         max(config.num_triangles - 1, 0))
    g = take(buffers["tri_pT"], tri_id, dim=1)
    r, state = rng.next_f32(state)
    s, state = rng.next_f32(state)
    flip = (r + s) > 1.0
    r = torch.where(flip, 1.0 - r, r)
    s = torch.where(flip, 1.0 - s, s)
    w0 = 1.0 - r - s
    tri_pt = V3(g[0] * w0 + g[3] * r + g[6] * s,
                g[1] * w0 + g[4] * r + g[7] * s,
                g[2] * w0 + g[5] * r + g[8] * s)
    tri_dir = (tri_pt - position).normalized()
    if config.num_emit_spheres == 0:
        return tri_dir, state
    m = take(buffers["eo_matrixT"], eo, dim=1)
    center = V3(m[3], m[7], m[11])
    radius = (torch.sqrt(m[0] ** 2 + m[4] ** 2 + m[8] ** 2)
              + torch.sqrt(m[1] ** 2 + m[5] ** 2 + m[9] ** 2)
              + torch.sqrt(m[2] ** 2 + m[6] ** 2 + m[10] ** 2)) / 3.0
    to_c = center - position
    d2 = torch.clamp_min(to_c.dot(to_c), 1e-12)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - radius * radius / d2, 0.0))
    inside = d2 <= radius * radius
    u1, state = rng.next_f32(state)
    u2, state = rng.next_f32(state)
    cos_t = torch.where(inside, 1.0 - 2.0 * u1, 1.0 - u1 * (1.0 - cos_max))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2
    onb = v3.Onb.from_w(to_c.normalized())
    sph_dir = (onb.u * (torch.cos(phi) * sin_t)
               + onb.v * (torch.sin(phi) * sin_t) + onb.w * cos_t)
    return v3.where(kind == T.KIND_SPHERE, sph_dir, tri_dir), state


def random_unit_vector(state):
    """A uniform direction on the sphere (math.rs:8-20, in closed form)."""
    u1, state = rng.next_f32(state)
    u2, state = rng.next_f32(state)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z), state

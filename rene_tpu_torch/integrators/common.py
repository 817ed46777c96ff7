"""Light sampling of the megakernel's path body.

Counterparts in rene_tpu/integrators/pallas_path.py: `sample_emit`
(:3439-3493), the direction half of the 50/50 emitter/BSDF MIS; and the
distant-light NEE fold (`fold_lights` :2696 over `_dist_body`
:4408-4433).
"""
from __future__ import annotations

import torch

from ..ops.bsdf import bsdf_eval
from ..ops.intersect import TMIN, TWO_PI, shadow_any
from ..ops.vec3 import normalize3, onb_from_w, to_local
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

"""Frozen copy of rene_tpu_torch/ops/intersect.py at commit ed2dcef; the XLA
engine's casts and the probe's cast_ref left out.

Ray casts of the megakernel over the scene's triangles and spheres.

Counterpart of pallas_path.py `trace_closest` (:2775-3116), `trace_any`
(:3117-3217, in the constant-direction form that distant-light shadows
take), `trace_emit_pdf` (:3218-3279) and the volpath body's transmittance
march `tr_march` (:3363-3430). The immediates (triangles, then
spheres) come first; the mesh (ops/bvh.py: world mesh, then each shared-
BLAS instance) is marched from their closest t and replaces their hit
only where it is closer; the sphere table comes last. Mesh triangles and
table spheres are never emissive, and the emitter pdf sees the emissive
immediates alone.

The TPU kernel unrolls one test per primitive and keeps the closest hit
with `t < t_best` selects. Here all primitives are tested at once as an
(N, P) block; the winner is the first primitive with the smallest valid
t, which is the same primitive the sequential strict-less chain keeps
(triangles first, then spheres). Its attributes are then recomputed for
that primitive alone, with the same arithmetic.

The XLA engine's casts follow at the end (rene_tpu/ops/intersect.py):
`trace`, `occluded` and `trace_emissive_pdf` over V3 rays, through the
scene's accelerator (ops/accel.py: the matrix-product intersector, or the
BVH's per-lane stack walk) or by brute force (`intersect_triangles`),
with the spheres tested one after another.
"""
from __future__ import annotations

import math

import torch

from ..scene import pack as P
from ..scene import types as T
from . import bvh
from . import vec3 as v3
from .bvh import BIG
from .gather import at, host_values, take
from .texture import sphere_uv_of
from .vec3 import V3, normalize3

TMIN = 1e-3
TWO_PI = 2.0 * math.pi
MAX_TR_MARCH = 32   # pallas_path.py:3363
# ray casts of the volpath body so far, by kind (reset by the caller):
# closest hits of its bounces, steps of its transmittance marches (each a
# closest hit) and emitter-pdf casts; a lane counts where it needs the
# cast, as a CUDA thread casts it
casts = {"closest": 0, "march": 0, "emit_pdf": 0}
# the rays of the casts, recorded where a list (set by the caller, for the
# ray-cast probe, rene_tpu_torch.probe): each call of `closest` or
# `shadow_any` appends its (N, RAY_W) rows of the lanes it walks, in the
# layout of kernels.cast_probe
ray_log = None
RAY_W, CAST_CLOSEST, CAST_SHADOW = 10, 0, 1


def _log_rays(kind, li, ox, oy, oz, dx, dy, dz, tmin, tmax, skip):
    keep = (torch.ones_like(ox, dtype=torch.bool) if skip is None
            else ~skip)
    z = torch.zeros_like(ox)
    rows = torch.stack((ox, oy, oz, dx, dy, dz, z + tmin, z + tmax,
                        z + kind, z + li), 1)
    ray_log.append(rows[keep])


def _tri_sides(rows, ox, oy, oz, dx, dy, dz, wx, wy, wz):
    """Plücker side values and plane distance of rays against triangles;
    `rows` is (P, TRI_W) with lanes (N, 1), or (N, TRI_W) with lanes (N,)."""
    def c(o):
        return rows[..., o]

    s0 = (dx * c(P.TRI_M0) + dy * c(P.TRI_M0 + 1) + dz * c(P.TRI_M0 + 2)) \
        + (wx * c(P.TRI_E0) + wy * c(P.TRI_E0 + 1) + wz * c(P.TRI_E0 + 2))
    s1 = (dx * c(P.TRI_M1) + dy * c(P.TRI_M1 + 1) + dz * c(P.TRI_M1 + 2)) \
        + (wx * c(P.TRI_E1) + wy * c(P.TRI_E1 + 1) + wz * c(P.TRI_E1 + 2))
    s2 = (dx * c(P.TRI_M2) + dy * c(P.TRI_M2 + 1) + dz * c(P.TRI_M2 + 2)) \
        + (wx * c(P.TRI_E2) + wy * c(P.TRI_E2 + 1) + wz * c(P.TRI_E2 + 2))
    dn = dx * c(P.TRI_PN) + dy * c(P.TRI_PN + 1) + dz * c(P.TRI_PN + 2)
    t = (c(P.TRI_PK) - (ox * c(P.TRI_PN) + oy * c(P.TRI_PN + 1)
                        + oz * c(P.TRI_PN + 2))) \
        / torch.where(torch.abs(dn) > 1e-12, dn, 1e-12)
    return s0, s1, s2, dn, t


def _side_ok(s0, s1, s2, dn):
    side = ((s0 >= 0) & (s1 >= 0) & (s2 >= 0)) | \
        ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    return side & (torch.abs(dn) > 1e-12)


def _sphere_local(rows, ox, oy, oz, dx, dy, dz):
    """Ray in each sphere's object space (W2O applied)."""
    def m(r, k):
        return rows[..., P.SPH_W2O + 4 * r + k]

    lox = m(0, 0) * ox + m(0, 1) * oy + m(0, 2) * oz + m(0, 3)
    loy = m(1, 0) * ox + m(1, 1) * oy + m(1, 2) * oz + m(1, 3)
    loz = m(2, 0) * ox + m(2, 1) * oy + m(2, 2) * oz + m(2, 3)
    ldx = m(0, 0) * dx + m(0, 1) * dy + m(0, 2) * dz
    ldy = m(1, 0) * dx + m(1, 1) * dy + m(1, 2) * dz
    ldz = m(2, 0) * dx + m(2, 1) * dy + m(2, 2) * dz
    return lox, loy, loz, ldx, ldy, ldz


def _sphere_t(lox, loy, loz, ldx, ldy, ldz, tmin):
    """Nearest root >= tmin of the unit sphere, BIG where none."""
    a = ldx * ldx + ldy * ldy + ldz * ldz
    half_b = lox * ldx + loy * ldy + loz * ldz
    c = lox * lox + loy * loy + loz * loz - 1.0
    disc = half_b * half_b - a * c
    sq = bvh.sqrt_rn(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / torch.clamp_min(a, 1e-20)
    r0 = (-half_b - sq) * inv_a
    r1 = (-half_b + sq) * inv_a
    okd = disc >= 0.0
    return torch.where(okd & (r0 >= tmin), r0,
                       torch.where(okd & (r1 >= tmin), r1, BIG))


def _lanes(*xs):
    return tuple(x[:, None] for x in xs)


def closest(tabs, ox, oy, oz, dx, dy, dz, tmin=TMIN, skip=None, ids=None):
    """(t, hit, nx, ny, nz, emit r, g, b, material id, u, v): t is BIG on
    a miss, the normal is the interpolated shading normal (not
    normalized). (u, v) are the hit's texture coordinates where the scene
    has a textured material (`tabs["has_tex"]`), else zero: interpolated
    from the vertices of a triangle, spherical on a sphere
    (`sphere_uv_of` of the object-space hit point), zero on a table
    sphere, whose material is solid. Lanes where `skip` walk neither the
    mesh nor the sphere table (their result is not used). On an exact tie
    in t the lowest part and row win (ops/bvh.py); where `ids` is a dict
    it receives the (N,) part and row of the hit (csrc/intersect.cuh
    Hit), -1 on a miss."""
    if ray_log is not None:
        _log_rays(CAST_CLOSEST, 0, ox, oy, oz, dx, dy, dz, tmin, BIG, skip)
    tris, sph = tabs["tris"], tabs["spheres"]
    n_tri, n_sph = tris.shape[0], sph.shape[0]
    wx = oy * dz - oz * dy
    wy = oz * dx - ox * dz
    wz = ox * dy - oy * dx
    lanes = _lanes(ox, oy, oz, dx, dy, dz)
    cand = []
    if n_tri:
        s0, s1, s2, dn, t = _tri_sides(tris, *lanes, *_lanes(wx, wy, wz))
        ok = _side_ok(s0, s1, s2, dn) & (t >= tmin)
        cand.append(torch.where(ok, t, math.inf))
    if n_sph:
        cand.append(_sphere_t(*_sphere_local(sph, *lanes), tmin))
    zero = torch.zeros_like(ox)
    cand.append((zero + BIG)[:, None])
    t_best, idx = torch.cat(cand, dim=1).min(dim=1)
    hit = t_best < BIG
    t = torch.where(hit, t_best, BIG)

    nx = ny = nz = er = eg = eb = uu = vv = zero
    want_uv = tabs["has_tex"]
    mat = torch.zeros_like(idx)
    if n_tri:
        is_tri = hit & (idx < n_tri)
        rows = tris[idx.clamp(max=n_tri - 1)]
        s0, s1, s2, _, _ = _tri_sides(rows, ox, oy, oz, dx, dy, dz,
                                      wx, wy, wz)
        denom = s0 + s1 + s2
        denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        bu = s2 / denom
        bv = s0 / denom
        w0 = 1.0 - bu - bv
        tn = [w0 * rows[:, P.TRI_N0 + k] + bu * rows[:, P.TRI_N1 + k]
              + bv * rows[:, P.TRI_N2 + k] for k in range(3)]
        nx = torch.where(is_tri, tn[0], nx)
        ny = torch.where(is_tri, tn[1], ny)
        nz = torch.where(is_tri, tn[2], nz)
        er = torch.where(is_tri, rows[:, P.TRI_EMIT], er)
        eg = torch.where(is_tri, rows[:, P.TRI_EMIT + 1], eg)
        eb = torch.where(is_tri, rows[:, P.TRI_EMIT + 2], eb)
        mat = torch.where(is_tri, rows[:, P.TRI_MAT].long(), mat)
        if want_uv:
            tuv = [w0 * rows[:, P.TRI_UV0 + k] + bu * rows[:, P.TRI_UV1 + k]
                   + bv * rows[:, P.TRI_UV2 + k] for k in range(2)]
            uu = torch.where(is_tri, tuv[0], uu)
            vv = torch.where(is_tri, tuv[1], vv)
    if n_sph:
        is_sph = hit & (idx >= n_tri)
        rows = sph[(idx - n_tri).clamp(0, n_sph - 1)]
        lox, loy, loz, ldx, ldy, ldz = _sphere_local(rows, ox, oy, oz,
                                                     dx, dy, dz)
        px_ = lox + t * ldx
        py_ = loy + t * ldy
        pz_ = loz + t * ldz

        def m(r, k):
            return rows[:, P.SPH_W2O + 4 * r + k]

        sn = [m(0, k) * px_ + m(1, k) * py_ + m(2, k) * pz_ for k in range(3)]
        nx = torch.where(is_sph, sn[0], nx)
        ny = torch.where(is_sph, sn[1], ny)
        nz = torch.where(is_sph, sn[2], nz)
        er = torch.where(is_sph, rows[:, P.SPH_EMIT], er)
        eg = torch.where(is_sph, rows[:, P.SPH_EMIT + 1], eg)
        eb = torch.where(is_sph, rows[:, P.SPH_EMIT + 2], eb)
        mat = torch.where(is_sph, rows[:, P.SPH_MAT].long(), mat)
        if want_uv:
            su, sv = sphere_uv_of(px_, py_, pz_)
            uu = torch.where(is_sph, su, uu)
            vv = torch.where(is_sph, sv, vv)
    if ids is not None:
        ids["part"] = torch.where(hit, bvh.PART_IMM, -1)
        ids["row"] = torch.where(hit, idx, -1)
    for part, n_rows in ((bvh.mesh_closest, tabs["nodes"].shape[0]),
                         (bvh.sphere_table_closest,
                          tabs["sph_tab"].shape[0])):
        if not n_rows:
            continue
        got = {}
        tp, pnx, pny, pnz, pmat, pu, pv = part(tabs, ox, oy, oz, dx, dy, dz,
                                               tmin, t, skip, ids=got)
        win = tp < t
        if ids is not None:
            ids["part"] = torch.where(win, got.get(
                "part", bvh.PART_INST + len(tabs["insts_f"])), ids["part"])
            ids["row"] = torch.where(win, got["row"], ids["row"])
        t = torch.where(win, tp, t)
        nx = torch.where(win, pnx, nx)
        ny = torch.where(win, pny, ny)
        nz = torch.where(win, pnz, nz)
        er = torch.where(win, 0.0, er)
        eg = torch.where(win, 0.0, eg)
        eb = torch.where(win, 0.0, eb)
        mat = torch.where(win, pmat, mat)
        uu = torch.where(win, pu, uu)
        vv = torch.where(win, pv, vv)
        hit = t < BIG
    return t, hit, nx, ny, nz, er, eg, eb, mat, uu, vv


def shadow_any(tabs, li, ox, oy, oz, dx, dy, dz, tmin, tmax, skip=None):
    """Any hit in [tmin, tmax] along distant light `li`'s direction d (the
    same for every lane); lanes where `skip` walk neither the mesh nor
    the sphere table. The direction's dot products with each
    triangle's Plücker moments and plane normal come precomputed from the
    host (`light_dots`), as the JAX kernel folds them into constants."""
    if ray_log is not None:
        _log_rays(CAST_SHADOW, li, ox, oy, oz, dx, dy, dz, tmin, tmax, skip)
    tris, sph = tabs["tris"], tabs["spheres"]
    hit = torch.zeros_like(ox, dtype=torch.bool)
    lanes = _lanes(ox, oy, oz, dx, dy, dz)
    if tris.shape[0]:
        dots = tabs["light_dots"][li]
        wx = oy * dz - oz * dy
        wy = oz * dx - ox * dz
        wz = ox * dy - oy * dx
        w = _lanes(wx, wy, wz)

        def side(dcol, eoff):
            return dots[:, dcol] + (w[0] * tris[:, eoff]
                                    + w[1] * tris[:, eoff + 1]
                                    + w[2] * tris[:, eoff + 2])

        s0 = side(0, P.TRI_E0)
        s1 = side(1, P.TRI_E1)
        s2 = side(2, P.TRI_E2)
        dn = dots[:, 3]
        o = lanes[:3]
        t = (tris[:, P.TRI_PK] - (o[0] * tris[:, P.TRI_PN]
                                  + o[1] * tris[:, P.TRI_PN + 1]
                                  + o[2] * tris[:, P.TRI_PN + 2])) \
            / torch.where(torch.abs(dn) > 1e-12, dn, 1e-12)
        ok = _side_ok(s0, s1, s2, dn) & (t >= tmin) & (t <= tmax)
        hit = hit | ok.any(dim=1)
    if sph.shape[0]:
        t = _sphere_t(*_sphere_local(sph, *lanes), tmin)
        hit = hit | (t <= tmax).any(dim=1)
    if tabs["nodes"].shape[0]:
        hit = hit | bvh.mesh_any(tabs, ox, oy, oz, dx, dy, dz, tmin, tmax,
                                 hit if skip is None else hit | skip)
    if tabs["sph_tab"].shape[0]:
        hit = hit | bvh.sphere_table_any(
            tabs, ox, oy, oz, dx, dy, dz, tmin, tmax,
            hit if skip is None else hit | skip)
    return hit


def emit_pdf(tabs, ox, oy, oz, dx, dy, dz):
    """Solid-angle pdf of the emitter sampler for direction d: the closest
    EMISSIVE primitive along the ray (occluders are ignored) decides it;
    0 where the ray hits no emitter."""
    tris, sph = tabs["tris"], tabs["spheres"]
    et, es = tabs["emit_tris"].long(), tabs["emit_spheres"].long()
    lanes = _lanes(ox, oy, oz, dx, dy, dz)
    ndx, ndy, ndz = _lanes(*normalize3(dx, dy, dz))
    ts, ps = [], []
    if et.shape[0]:
        rows = tris[et]
        wx = oy * dz - oz * dy
        wy = oz * dx - ox * dz
        wz = ox * dy - oy * dx
        s0, s1, s2, dn, t = _tri_sides(rows, *lanes, *_lanes(wx, wy, wz))
        ok = _side_ok(s0, s1, s2, dn) & (t >= TMIN)
        ldx, ldy, ldz = lanes[3:]
        dist2 = t * t * (ldx * ldx + ldy * ldy + ldz * ldz)
        gn = rows[:, P.TRI_GN:P.TRI_GN + 3]
        cosine = torch.abs(ndx * gn[:, 0] + ndy * gn[:, 1] + ndz * gn[:, 2])
        p = dist2 / torch.clamp_min(cosine * rows[:, P.TRI_AREA], 1e-20) \
            / rows[:, P.TRI_PRIMS]
        ts.append(torch.where(ok, t, math.inf))
        ps.append(p)
    if es.shape[0]:
        rows = sph[es]
        t = _sphere_t(*_sphere_local(rows, *lanes), TMIN)
        o = lanes[:3]
        ex = rows[:, P.SPH_O2W + 3] - o[0]
        ey = rows[:, P.SPH_O2W + 7] - o[1]
        ez = rows[:, P.SPH_O2W + 11] - o[2]
        d2 = ex * ex + ey * ey + ez * ez
        r2 = rows[:, P.SPH_R2]
        cos_max = bvh.sqrt_rn(torch.clamp_min(
            1.0 - r2 / torch.clamp_min(d2, 1e-20), 0.0))
        p = torch.where(d2 <= r2, 1.0 / (2.0 * TWO_PI),
                        1.0 / torch.clamp_min(TWO_PI * (1.0 - cos_max),
                                              1e-20))
        ts.append(t)
        ps.append(p)
    if not ts:
        return torch.zeros_like(ox)
    t_best, idx = torch.cat(ts, dim=1).min(dim=1)
    pdf = torch.cat(ps, dim=1).gather(1, idx[:, None])[:, 0]
    return torch.where(t_best < BIG, pdf, 0.0)


def tr_march(tabs, ox, oy, oz, dx, dy, dz, med, want_emit: bool,
             skip=None):
    """Transmittance rgb from o along d (`tr_march` :3365-3430; lib.rs
    tr / tr_emit): up to MAX_TR_MARCH closest hits per lane, passing
    through `Material "none"` surfaces and switching to the surface's
    exterior medium where d leaves it (d . n > 0), else its interior.
    Without `want_emit` a miss gives the transmittance so far and any
    other surface 0; with it, a front-facing emitter gives the
    transmittance times its radiance, and the march stops at any
    emitter. `med` holds each lane's medium; lanes where `skip` march
    nowhere and give 0. Only the live lanes are cast, and counted in
    `casts["march"]`."""
    from .medium import med_tr
    mats, media = tabs["mats"], tabs["media"]
    zero = torch.zeros_like(ox)
    out = [zero, zero, zero]
    live = torch.ones_like(ox, dtype=torch.bool) if skip is None else ~skip
    idx = torch.nonzero(live).squeeze(1)
    o = [ox[idx], oy[idx], oz[idx]]
    d = [dx[idx], dy[idx], dz[idx]]
    m = med[idx]
    tr = [torch.ones_like(o[0]) for _ in range(3)]
    acc = [torch.zeros_like(o[0]) for _ in range(3)]
    for _ in range(MAX_TR_MARCH):
        if not idx.numel():
            break
        casts["march"] += int(idx.numel())
        t, hit, nx, ny, nz, er, eg, eb, mat, _, _ = closest(
            tabs, *o, *d, TMIN)
        rows = mats[mat]
        mat_none = rows[:, P.MAT_TYPE] == float(T.MAT_NONE)
        if want_emit:
            emissive = (er != 0.0) | (eg != 0.0) | (eb != 0.0)
            unx, uny, unz = normalize3(nx, ny, nz)
            front = (-(d[0] * unx + d[1] * uny + d[2] * unz)) > 0.0
            take = hit & emissive & front
            for c, e in enumerate((er, eg, eb)):
                acc[c] = acc[c] + torch.where(take, tr[c] * e, 0.0)
            stop = ~hit | emissive | ~mat_none
        else:
            for c in range(3):
                acc[c] = acc[c] + torch.where(~hit, tr[c], 0.0)
            stop = ~hit | ~mat_none
        seg = med_tr(media, m, torch.clamp_max(t, 1e20))
        cont = ~stop
        tr = [torch.where(cont, tr[c] * seg[c], tr[c]) for c in range(3)]
        out_ = (d[0] * nx + d[1] * ny + d[2] * nz) > 0.0
        m = torch.where(cont, torch.where(out_, rows[:, P.MAT_EMED],
                                          rows[:, P.MAT_IMED]), m)
        o = [torch.where(cont, o[c] + t * d[c], o[c]) for c in range(3)]
        # lanes that stopped hand their sums back; the rest march on
        for c in range(3):
            out[c] = out[c].index_put((idx[~cont],), acc[c][~cont])
        keep = torch.nonzero(cont).squeeze(1)
        idx = idx[keep]
        o, d = [a[keep] for a in o], [a[keep] for a in d]
        tr, acc = [a[keep] for a in tr], [a[keep] for a in acc]
        m = m[keep]
    return tuple(out)

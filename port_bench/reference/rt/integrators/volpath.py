"""Frozen copy of rene_tpu_torch/integrators/volpath.py at commit ed2dcef; the
XLA engine's half (max_depth_for onward) left out.

The volumetric path tracer on the port's main path (slice K1e).

Counterpart of rene_tpu/integrators/volpath.py by name and of the JAX
megakernel's volpath body by content: `body_vol` (pallas_path.py:
4572-4841) under the megakernel contract and `wave_bounce_vol`
(:5277-5565) under the wave contract. One bounce of a lane:

* the closest hit; on a miss, the background;
* distance sampling in the lane's medium along the segment to the hit
  (ops/medium.py); the throughput takes the medium's weight;
* a medium interaction: Henyey-Greenstein NEE to every distant light
  through the transmittance march (ops/intersect.py `tr_march`), the
  phase-sampled scatter direction, and with emitters, emitter NEE (one
  `sample_emit` direction, its pdf over E, `tr_march` for the emitter's
  radiance, no MIS);
* a surface interaction: the one-sided emitter hit, the AOVs at depth 0
  (None surfaces too), distant-light NEE through `tr_march`, and the path
  body's BSDF sampling with the 50/50 emitter/env MIS. A None surface
  passes the ray through: the origin moves, direction and throughput
  stay. The lane's medium switches at every surface it meets, to the
  surface's exterior medium where wo . n < 0, else its interior;
* no Russian roulette; depth counts None passthroughs too.

A bounce draws, in this order and on every lane: med_sample (2),
med_sample_p (2), ue1..ue4 of the medium's emitter NEE when the scene has
emitters, u_coin, u1, u2, ul, then coin, ue1..ue4 (and upick with both
emitters and an env map) when the scene has emitters or an env-map
strategy, then cj1, cj2. Under `Sampler "sobol"` the draws of the
surface's BSDF step and the camera come from ops/sobol.py's pairs, as
in the path body (pallas_path.py:4704-4731, :4811-4812), and the stream
keeps the medium's two, the phase function's two and the scatter point's
emitter draws (:3315-3316, :3346-3347, :4635-4638). Its nominal ray count
is the path body's, 1 + lights + (E > 0); `ops.intersect.casts` counts
the casts it makes.

`bounce_vol` is the plain PyTorch version of a bounce of
csrc/vol_loop.cuh's lane loop (`vol_step` over csrc/volpath.cuh's
`vol_shade` and its marches); mega_path.path_lanes_ref runs it for
volpath tables (`vol_lanes_ref`), as wave.wave_step_ref does.

`render_batch` is the XLA engine's volpath (rene_tpu/integrators/
volpath.py: `_tr_march`, `render_batch`, `render_sample`), with the loop,
the regeneration and the draw discipline of integrators/path.py and the
media of ops/medium_xla.py. Per bounce: the closest hit, distance
sampling along it, then a medium interaction (phase-function NEE to the
distant lights through `_tr_march`, emitter NEE, a Henyey-Greenstein
scatter) or a surface one (the path body's, with transmittance-weighted
NEE; a `None` surface passes the ray through and switches its medium);
no Russian roulette (lib.rs:787-799); maxdepth 80 by default.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import rng
from ..ops import intersect as X
from ..ops.bsdf import bsdf_eval, gather_material
from ..ops.medium import med_phase, med_sample, med_sample_p
from ..ops.texture import apply_textures, background
from ..ops.vec3 import dot3, normalize3, onb_from_w, to_local
from ..scene import pack as P
from ..scene import types as T
from ..ops.gather import at
from .common import sample_emit
from .mega_path import (FLT_MIN_NORMAL, camera_draws, path_lanes_ref,
                        scatter)


def bounce_vol(tabs, c, active, beckmann: bool = False) -> Dict:
    """One volpath bounce of the lanes where `active`. `c` is the lane
    state of mega_path.bounce plus `med`, each lane's medium. Returns
    the updated sums, `alive`, the next origin (hx, hy, hz: the scatter
    point, or the surface hit), direction (wx, wy, wz), throughput (cr,
    cg, cb) and medium (med), `scattered` (the lane scattered in its
    medium), the advanced streams `st` and the camera draws cj1, cj2
    (None under Sobol, as in mega_path.bounce)."""
    E = tabs["n_emit"]
    media = tabs["media"]
    cr, cg, cb = c["cr"], c["cg"], c["cb"]
    med, depth = c["med"], c["depth"]
    X.casts["closest"] += int(active.sum())

    t, hit, anx_, any__, anz_, alr, alg, alb, mat_id, tu, tv = X.closest(
        tabs, c["ox"], c["oy"], c["oz"], c["dx"], c["dy"], c["dz"], X.TMIN,
        skip=~active)
    attr = gather_material(tabs["mats"], mat_id, hit)
    if tabs["has_tex"]:
        attr = apply_textures(tabs, attr, mat_id, active & hit, tu, tv)
    slot = torch.where(hit[:, None], tabs["mats"][mat_id], 0.0)
    miss = active & ~hit
    bg = background(tabs, c["dx"], c["dy"], c["dz"], miss)
    rr_ = c["rr"] + torch.where(miss, cr * bg[0], 0.0)
    rg_ = c["rg"] + torch.where(miss, cg * bg[1], 0.0)
    rb_ = c["rb"] + torch.where(miss, cb * bg[2], 0.0)
    alive = active & hit

    hx = c["ox"] + t * c["dx"]
    hy = c["oy"] + t * c["dy"]
    hz = c["oz"] + t * c["dz"]
    nx, ny, nz = normalize3(anx_, any__, anz_)
    wox, woy, woz = -c["dx"], -c["dy"], -c["dz"]
    ux, uy, uz, vx, vy, vz = onb_from_w(nx, ny, nz)
    mat_none = attr["mat"] == float(T.MAT_NONE)

    # distance sampling along the segment
    sampled, t_med, mw, st = med_sample(media, med, t, c["st"])
    sampled = sampled & alive
    cr = torch.where(alive, cr * mw[0], cr)
    cg = torch.where(alive, cg * mw[1], cg)
    cb = torch.where(alive, cb * mw[2], cb)
    mpx = c["ox"] + t_med * c["dx"]
    mpy = c["oy"] + t_med * c["dy"]
    mpz = c["oz"] + t_med * c["dz"]

    # ---- medium interaction: phase NEE to the distant lights
    zf = mpx * 0.0
    for ldx, ldy, ldz, lcr, lcg, lcb in tabs["lights_f"]:
        trv = X.tr_march(tabs, mpx, mpy, mpz, zf + ldx, zf + ldy, zf + ldz,
                         med, False, skip=~sampled)
        phase = med_phase(media, med, wox * ldx + woy * ldy + woz * ldz)
        rr_ = rr_ + torch.where(sampled, cr * trv[0] * phase * lcr, 0.0)
        rg_ = rg_ + torch.where(sampled, cg * trv[1] * phase * lcg, 0.0)
        rb_ = rb_ + torch.where(sampled, cb * trv[2] * phase * lcb, 0.0)
    m_dx, m_dy, m_dz, st = med_sample_p(media, med, wox, woy, woz, st)
    if E > 0:
        # emitter NEE from the scatter point, without MIS
        ue1, st = rng.uniform(st)
        ue2, st = rng.uniform(st)
        ue3, st = rng.uniform(st)
        ue4, st = rng.uniform(st)
        ls_x, ls_y, ls_z = sample_emit(tabs, mpx, mpy, mpz,
                                       ue1, ue2, ue3, ue4)
        X.casts["emit_pdf"] += int(sampled.sum())
        epdf = X.emit_pdf(tabs, mpx, mpy, mpz, ls_x, ls_y, ls_z) / float(E)
        ok_e = sampled & (epdf > 1e-5)
        tr_e = X.tr_march(tabs, mpx, mpy, mpz, ls_x, ls_y, ls_z, med, True,
                          skip=~ok_e)
        phase_e = med_phase(media, med, wox * ls_x + woy * ls_y
                            + woz * ls_z) / torch.clamp_min(epdf, 1e-5)
        rr_ = rr_ + torch.where(ok_e, cr * tr_e[0] * phase_e, 0.0)
        rg_ = rg_ + torch.where(ok_e, cg * tr_e[1] * phase_e, 0.0)
        rb_ = rb_ + torch.where(ok_e, cb * tr_e[2] * phase_e, 0.0)

    # ---- surface interaction
    surf = alive & ~sampled
    wo_n = dot3(wox, woy, woz, nx, ny, nz)
    al_on = surf & ((alr != 0.0) | (alg != 0.0) | (alb != 0.0)) \
        & (wo_n > 0.0)
    rr_ = rr_ + torch.where(al_on, cr * alr, 0.0)
    rg_ = rg_ + torch.where(al_on, cg * alg, 0.0)
    rb_ = rb_ + torch.where(al_on, cb * alb, 0.0)

    first = surf & (depth == 0)
    anx = c["anx"] + torch.where(first, nx, 0.0)
    any_ = c["any"] + torch.where(first, ny, 0.0)
    anz = c["anz"] + torch.where(first, nz, 0.0)
    aar = c["aar"] + torch.where(first, attr["abr"], 0.0)
    aag = c["aag"] + torch.where(first, attr["abg"], 0.0)
    aab = c["aab"] + torch.where(first, attr["abb"], 0.0)

    frame = (ux, uy, uz, vx, vy, vz, nx, ny, nz)
    lo = to_local(*frame, wox, woy, woz)
    surf_scatter = surf & ~mat_none

    # distant lights through the transmittance march
    zf = hx * 0.0
    for ldx, ldy, ldz, lcr, lcg, lcb in tabs["lights_f"]:
        bdx, bdy, bdz = zf + ldx, zf + ldy, zf + ldz
        trv = X.tr_march(tabs, hx, hy, hz, bdx, bdy, bdz, med, False,
                         skip=~surf_scatter)
        lwx, lwy, lwz = to_local(*frame, bdx, bdy, bdz)
        fe_r, fe_g, fe_b, _ = bsdf_eval(attr, *lo, lwx, lwy, lwz, beckmann)
        cosl = torch.abs(ldx * nx + ldy * ny + ldz * nz)
        rr_ = rr_ + torch.where(surf_scatter,
                                cr * trv[0] * fe_r * cosl * lcr, 0.0)
        rg_ = rg_ + torch.where(surf_scatter,
                                cg * trv[1] * fe_g * cosl * lcg, 0.0)
        rb_ = rb_ + torch.where(surf_scatter,
                                cb * trv[2] * fe_b * cosl * lcb, 0.0)

    # BSDF sampling with the emitter/env MIS of the path body
    sob = c.get("sob")
    wx_, wy_, wz_, f_r, f_g, f_b, pdf, diffuse, st = scatter(
        tabs, attr, frame, lo, hx, hy, hz, st, beckmann, sob)
    if E > 0:
        X.casts["emit_pdf"] += int((surf_scatter & diffuse).sum())

    cosw = torch.abs(wx_ * nx + wy_ * ny + wz_ * nz)
    scale = cosw / torch.clamp_min(pdf, 1e-20)
    # the next ray of a scattered, a surface and a None lane
    new_o = [torch.where(sampled, m, torch.where(surf, h, c[k]))
             for m, h, k in ((mpx, hx, "ox"), (mpy, hy, "oy"),
                             (mpz, hz, "oz"))]
    new_d = [torch.where(sampled, m, torch.where(surf_scatter, w, c[k]))
             for m, w, k in ((m_dx, wx_, "dx"), (m_dy, wy_, "dy"),
                             (m_dz, wz_, "dz"))]
    cr = torch.where(surf_scatter, cr * f_r * scale, cr)
    cg = torch.where(surf_scatter, cg * f_g * scale, cg)
    cb = torch.where(surf_scatter, cb * f_b * scale, cb)
    alive = alive & (sampled | (surf & (mat_none | (pdf >= 1e-5))))
    # the medium on the far side of a surface
    new_med = torch.where(surf, torch.where(
        wo_n < 0.0, slot[:, P.MAT_EMED], slot[:, P.MAT_IMED]), med)
    # a throughput below the normal range counts as zero, as under the
    # flush-to-zero arithmetic of XLA and the TPU
    alive = alive & (torch.maximum(cr, torch.maximum(cg, cb))
                     >= FLT_MIN_NORMAL)
    alive = alive & (depth + 1 < tabs["max_depth"])
    cj1, cj2, st = camera_draws(st, sob)
    return {"rr": rr_, "rg": rg_, "rb": rb_, "anx": anx, "any": any_,
            "anz": anz, "aar": aar, "aag": aag, "aab": aab,
            "alive": alive, "hx": new_o[0], "hy": new_o[1], "hz": new_o[2],
            "wx": new_d[0], "wy": new_d[1], "wz": new_d[2],
            "cr": cr, "cg": cg, "cb": cb, "med": new_med,
            "scattered": sampled, "st": st, "cj1": cj1, "cj2": cj2}


def vol_lanes_ref(tabs, seed: int, num_samples: int, beckmann: bool = False,
                  lanes=None, pack: int = 1) -> torch.Tensor:
    """Plain PyTorch volpath megakernel: the (10, N) per-lane sums of
    mega_path.path_lanes_ref over the same lanes (`pack` sample slots per
    pixel on cluster-mode tables), with the volpath bounce and each
    lane's medium (vacuum on every camera ray)."""
    if not tabs["volpath"]:
        raise ValueError("vol_lanes_ref: the scene's integrator is path")
    return path_lanes_ref(tabs, seed, num_samples, beckmann, lanes, pack)


# -- the XLA engine's volpath (rene_tpu/integrators/volpath.py) ------------

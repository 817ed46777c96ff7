"""Frozen copy of rene_tpu_torch/ops/bsdf.py at commit ed2dcef.

BSDF evaluation and sampling of the megakernel, for all 8 material types
with solid textures.

Counterpart of pallas_path.py `bsdf_eval` (:3685-3832), `bsdf_sample`
(:3834-4108) and `is_diffuse` (:4113-4130). The TPU kernel selects the
material's constants per primitive from immediates; here they are
gathered per lane from the material table (`gather_material`), and every
material's branch is evaluated under a `where` on the lane's type, as the
JAX kernel does. Vectors are in the shading frame (z = normal).

The XLA engine's BSDF follows at the end: rene_tpu/ops/bsdf.py's lobe
slots (a list of up to five dicts, one BxDF per slot, built by
`compute_bsdf` for the material classes the scene holds) with `bsdf_f`,
`bsdf_pdf` and `bsdf_sample_f`, which draw from the PCG32si stream.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..scene import types as T

from ..scene import pack as P
from . import fresnel as fr
from . import microfacet as mf
from . import rng
from . import vec3 as v3
from .fresnel import fr_conductor_ch, fr_dielectric
from .gather import at
from .microfacet import ggx_d, ggx_lambda, sample_wh, wh_pdf
from .texture import tex_color
from .vec3 import V3, dot3, normalize3

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


def gather_material(mats: torch.Tensor, mat_id: torch.Tensor,
                    hit: torch.Tensor) -> dict:
    """Per-lane shading attributes (the keys the JAX kernel's closest-hit
    trace produces) of material `mat_id`; lanes that missed get zeros."""
    rows = torch.where(hit[:, None], mats[mat_id], 0.0)
    names = {"mat": P.MAT_TYPE,
             "abr": P.MAT_ALBEDO, "abg": P.MAT_ALBEDO + 1,
             "abb": P.MAT_ALBEDO + 2,
             "etar": P.MAT_ETA, "etag": P.MAT_ETA + 1, "etab": P.MAT_ETA + 2,
             "kr": P.MAT_K, "kg": P.MAT_K + 1, "kb": P.MAT_K + 2,
             "ax": P.MAT_ALPHA, "ay": P.MAT_ALPHA + 1, "ir": P.MAT_IR,
             "opr": P.MAT_OP, "opg": P.MAT_OP + 1, "opb": P.MAT_OP + 2,
             "krr": P.MAT_KR2, "krg": P.MAT_KR2 + 1, "krb": P.MAT_KR2 + 2,
             "ktr": P.MAT_KT2, "ktg": P.MAT_KT2 + 1, "ktb": P.MAT_KT2 + 2,
             "msr": P.MAT_FSCALE, "msg": P.MAT_FSCALE + 1,
             "msb": P.MAT_FSCALE + 2}
    return {k: rows[:, c] for k, c in names.items()}


def _on(a, b, c):
    return (a != 0.0) | (b != 0.0) | (c != 0.0)


def bsdf_eval(attr, wox, woy, woz, wix, wiy, wiz, beckmann=False):
    """(f_r, f_g, f_b, pdf) of the diffuse-capable lobes; specular lobes
    contribute 0 to both."""
    mat = attr["mat"]
    same = woz * wiz > 0.0
    zero = torch.zeros_like(woz)
    f_r, f_g, f_b, pdf = zero, zero, zero, zero

    # matte
    sel = (mat == float(T.MAT_MATTE)) & same
    f_r = torch.where(sel, attr["abr"] * INV_PI, f_r)
    f_g = torch.where(sel, attr["abg"] * INV_PI, f_g)
    f_b = torch.where(sel, attr["abb"] * INV_PI, f_b)
    pdf = torch.where(sel, torch.abs(wiz) * INV_PI, pdf)

    # metal: microfacet reflection with the conductor Fresnel term
    sel = (mat == float(T.MAT_METAL)) & same
    hx, hy, hz = normalize3(wox + wix, woy + wiy, woz + wiz)
    hx = torch.where(hz < 0, -hx, hx)
    hy = torch.where(hz < 0, -hy, hy)
    hz = torch.where(hz < 0, -hz, hz)
    ax_, ay_ = attr["ax"], attr["ay"]
    d = ggx_d(ax_, ay_, hx, hy, hz, beckmann)
    g = 1.0 / (1.0 + ggx_lambda(ax_, ay_, wox, woy, woz, beckmann)
               + ggx_lambda(ax_, ay_, wix, wiy, wiz, beckmann))
    ci = torch.abs(wiz)
    co = torch.abs(woz)
    cos_ih = dot3(wix, wiy, wiz, hx, hy, hz)
    cl = torch.clamp(cos_ih, -1.0, 1.0)
    c2 = cl * cl
    s2 = 1.0 - c2
    cabs = torch.abs(cos_ih)
    fr_r = fr_conductor_ch(c2, s2, attr["etar"], attr["kr"], cabs) \
        * attr["msr"]
    fr_g = fr_conductor_ch(c2, s2, attr["etag"], attr["kg"], cabs) \
        * attr["msg"]
    fr_b = fr_conductor_ch(c2, s2, attr["etab"], attr["kb"], cabs) \
        * attr["msb"]
    base = d * g / torch.clamp_min(4.0 * ci * co, 1e-20)
    ok = sel & ~((ci == 0.0) | (co == 0.0))
    f_r = torch.where(ok, base * fr_r, f_r)
    f_g = torch.where(ok, base * fr_g, f_g)
    f_b = torch.where(ok, base * fr_b, f_b)
    pdf_wh = wh_pdf(ax_, ay_, wox, woy, woz, hx, hy, hz, d, beckmann)
    pdf = torch.where(sel, pdf_wh / torch.clamp_min(
        4.0 * dot3(wox, woy, woz, hx, hy, hz), 1e-20), pdf)

    # substrate: FresnelBlend (Kd in ab*, Ks in k*)
    sel = (mat == float(T.MAT_SUBSTRATE)) & same
    awi = torch.abs(wiz)
    awo = torch.abs(woz)

    def pw5(x):
        return (x * x) * (x * x) * x

    dterm = ((28.0 / (23.0 * math.pi))
             * (1.0 - pw5(1.0 - 0.5 * awi))
             * (1.0 - pw5(1.0 - 0.5 * awo)))
    hx0, hy0, hz0 = wox + wix, woy + wiy, woz + wiz
    degen = (hx0 * hx0 + hy0 * hy0 + hz0 * hz0) < 1e-18
    hx, hy, hz = normalize3(hx0, hy0, hz0)
    cos_ih = dot3(wix, wiy, wiz, hx, hy, hz)
    sch = pw5(torch.clamp(1.0 - cos_ih, 0.0, 1.0))
    d = ggx_d(ax_, ay_, hx, hy, hz, beckmann)
    sden = torch.clamp_min(4.0 * torch.abs(cos_ih)
                           * torch.maximum(awi, awo), 1e-20)
    sub = [ab * (1.0 - k) * dterm + (k + (1.0 - k) * sch) * d / sden
           for ab, k in ((attr["abr"], attr["kr"]), (attr["abg"], attr["kg"]),
                         (attr["abb"], attr["kb"]))]
    ok = sel & ~degen
    f_r = torch.where(ok, sub[0], f_r)
    f_g = torch.where(ok, sub[1], f_g)
    f_b = torch.where(ok, sub[2], f_b)
    doh = dot3(wox, woy, woz, hx, hy, hz)
    pdf_wh = wh_pdf(ax_, ay_, wox, woy, woz, hx, hy, hz, d, beckmann)
    p_sub = 0.5 * (awi * INV_PI + pdf_wh / torch.clamp_min(4.0 * doh, 1e-20))
    pdf = torch.where(ok, p_sub, pdf)

    # plastic / uber: lambert(Kd) + microfacet(Ks, dielectric Fresnel)
    hx0, hy0, hz0 = wox + wix, woy + wiy, woz + wiz
    degen = (hx0 * hx0 + hy0 * hy0 + hz0 * hz0) < 1e-18
    hx, hy, hz = normalize3(hx0, hy0, hz0)
    hx = torch.where(hz < 0, -hx, hx)
    hy = torch.where(hz < 0, -hy, hy)
    hz = torch.where(hz < 0, -hz, hz)
    d = ggx_d(ax_, ay_, hx, hy, hz, beckmann)
    g = 1.0 / (1.0 + ggx_lambda(ax_, ay_, wox, woy, woz, beckmann)
               + ggx_lambda(ax_, ay_, wix, wiy, wiz, beckmann))
    ci = torch.abs(wiz)
    co = torch.abs(woz)
    cos_ih = dot3(wix, wiy, wiz, hx, hy, hz)
    base = d * g / torch.clamp_min(4.0 * ci * co, 1e-20)
    mic_bad = (ci == 0.0) | (co == 0.0) | degen
    doh = dot3(wox, woy, woz, hx, hy, hz)
    pdf_wh = wh_pdf(ax_, ay_, wox, woy, woz, hx, hy, hz, d, beckmann)
    pdf_mic = pdf_wh / torch.clamp_min(4.0 * doh, 1e-20)
    kd_on = _on(attr["abr"], attr["abg"], attr["abb"])
    ks_on = _on(attr["kr"], attr["kg"], attr["kb"])
    ones = torch.ones_like(woz)
    for tag, ei, et, uber in ((T.MAT_PLASTIC, 1.5 * ones, ones, False),
                              (T.MAT_UBER, ones, attr["ir"] * ones, True)):
        sel = (mat == float(tag)) & same
        fr = fr_dielectric(cos_ih, ei, et)
        nact = kd_on.float() + ks_on.float()
        if uber:
            for a, b, c in (("opr", "opg", "opb"), ("krr", "krg", "krb"),
                            ("ktr", "ktg", "ktb")):
                nact = nact + _on(attr[a], attr[b], attr[c]).float()
        mic_ok = ks_on & ~mic_bad
        fv = [torch.where(kd_on, ab * INV_PI, 0.0)
              + torch.where(mic_ok, k * fr * base, 0.0)
              for ab, k in ((attr["abr"], attr["kr"]),
                            (attr["abg"], attr["kg"]),
                            (attr["abb"], attr["kb"]))]
        p = (torch.where(kd_on, torch.abs(wiz) * INV_PI, 0.0)
             + torch.where(ks_on, pdf_mic, 0.0)) / torch.clamp_min(nact, 1.0)
        f_r = torch.where(sel, fv[0], f_r)
        f_g = torch.where(sel, fv[1], f_g)
        f_b = torch.where(sel, fv[2], f_b)
        pdf = torch.where(sel, p, pdf)
    return f_r, f_g, f_b, pdf


def bsdf_sample(attr, wox, woy, woz, u_coin, u1, u2, ul, beckmann=False):
    """(wi xyz, f rgb, pdf) in the shading frame. `ul` picks the lobe of
    the multi-lobe materials (plastic, uber); their pdf is divided by the
    active-lobe count."""
    mat = attr["mat"]
    zero = torch.zeros_like(woz)
    ones = torch.ones_like(woz)
    wix, wiy, wiz = zero, zero, zero
    f_r, f_g, f_b, pdf = zero, zero, zero, zero
    ax_, ay_ = attr["ax"], attr["ay"]

    # cosine-weighted hemisphere on wo's side (matte, substrate, plastic,
    # uber)
    zc = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
    phi = TWO_PI * u1
    r2s = torch.sqrt(u2)
    cx = torch.cos(phi) * r2s
    cy = torch.sin(phi) * r2s
    cz = torch.where(woz < 0.0, -zc, zc)

    # matte
    sel = mat == float(T.MAT_MATTE)
    wix = torch.where(sel, cx, wix)
    wiy = torch.where(sel, cy, wiy)
    wiz = torch.where(sel, cz, wiz)
    f_r = torch.where(sel, attr["abr"] * INV_PI, f_r)
    f_g = torch.where(sel, attr["abg"] * INV_PI, f_g)
    f_b = torch.where(sel, attr["abb"] * INV_PI, f_b)
    pdf = torch.where(sel, torch.abs(cz) * INV_PI, pdf)

    # half-vector reflection (metal, substrate, plastic, uber)
    hx, hy, hz = sample_wh(ax_, ay_, wox, woy, woz, u1, u2, beckmann)
    doh = dot3(wox, woy, woz, hx, hy, hz)
    mx = -wox + 2.0 * doh * hx
    my = -woy + 2.0 * doh * hy
    mz = -woz + 2.0 * doh * hz
    mic_bad = (woz == 0.0) | (doh < 0.0) | (woz * mz <= 0.0)
    d = ggx_d(ax_, ay_, hx, hy, hz, beckmann)
    pdf_mic = (wh_pdf(ax_, ay_, wox, woy, woz, hx, hy, hz, d, beckmann)
               / torch.clamp_min(4.0 * doh, 1e-20))

    # metal
    sel = mat == float(T.MAT_METAL)
    fe_r, fe_g, fe_b, _ = bsdf_eval(
        {**attr, "mat": torch.full_like(woz, float(T.MAT_METAL))},
        wox, woy, woz, mx, my, mz, beckmann)
    wix = torch.where(sel, mx, wix)
    wiy = torch.where(sel, my, wiy)
    wiz = torch.where(sel, mz, wiz)
    good = sel & ~mic_bad
    f_r = torch.where(good, fe_r, torch.where(sel, 0.0, f_r))
    f_g = torch.where(good, fe_g, torch.where(sel, 0.0, f_g))
    f_b = torch.where(good, fe_b, torch.where(sel, 0.0, f_b))
    pdf = torch.where(good, pdf_mic, torch.where(sel, 0.0, pdf))

    # substrate: coin flip between the cosine lobe and the half-vector
    # reflection, then the shared FresnelBlend f/pdf
    sel = mat == float(T.MAT_SUBSTRATE)
    take_cos = u_coin < 0.5
    bwx = torch.where(take_cos, cx, mx)
    bwy = torch.where(take_cos, cy, my)
    bwz = torch.where(take_cos, cz, mz)
    fe_r, fe_g, fe_b, fe_pdf = bsdf_eval(
        {**attr, "mat": torch.full_like(woz, float(T.MAT_SUBSTRATE))},
        wox, woy, woz, bwx, bwy, bwz, beckmann)
    wix = torch.where(sel, bwx, wix)
    wiy = torch.where(sel, bwy, wiy)
    wiz = torch.where(sel, bwz, wiz)
    f_r = torch.where(sel, fe_r, f_r)
    f_g = torch.where(sel, fe_g, f_g)
    f_b = torch.where(sel, fe_b, f_b)
    pdf = torch.where(sel, fe_pdf, pdf)

    # mirror
    sel = mat == float(T.MAT_MIRROR)
    inv_c = 1.0 / torch.clamp_min(torch.abs(woz), 1e-9)
    wix = torch.where(sel, -wox, wix)
    wiy = torch.where(sel, -woy, wiy)
    wiz = torch.where(sel, woz, wiz)
    f_r = torch.where(sel, attr["abr"] * inv_c, f_r)
    f_g = torch.where(sel, attr["abg"] * inv_c, f_g)
    f_b = torch.where(sel, attr["abb"] * inv_c, f_b)
    pdf = torch.where(sel, 1.0, pdf)

    # glass: Fresnel-weighted choice of specular reflection / refraction
    sel = mat == float(T.MAT_GLASS)
    ir = attr["ir"]
    fd = fr_dielectric(woz, ones, ir)
    take_refl = u_coin < fd
    nz_ = torch.where(woz > 0.0, 1.0, -1.0)
    eta_ratio = torch.where(woz > 0.0, 1.0 / torch.clamp_min(ir, 1e-9), ir)
    cos_i = nz_ * woz
    sin2_t = eta_ratio * eta_ratio * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    ok_t = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    tx = -wox * eta_ratio
    ty = -woy * eta_ratio
    tz = -woz * eta_ratio + (eta_ratio * cos_i - cos_t) * nz_
    gx = torch.where(take_refl, -wox, tx)
    gy = torch.where(take_refl, -woy, ty)
    gz = torch.where(take_refl, woz, tz)
    val = torch.where(take_refl,
                      fd / torch.clamp_min(torch.abs(woz), 1e-9),
                      (1.0 - fd) / torch.clamp_min(torch.abs(gz), 1e-9))
    gp = torch.where(take_refl, fd, torch.where(ok_t, 1.0 - fd, 0.0))
    wix = torch.where(sel, gx, wix)
    wiy = torch.where(sel, gy, wiy)
    wiz = torch.where(sel, gz, wiz)
    f_r = torch.where(sel, val, f_r)
    f_g = torch.where(sel, val, f_g)
    f_b = torch.where(sel, val, f_b)
    pdf = torch.where(sel, gp, pdf)

    # plastic / uber: uniform pick among the active lobes
    g = 1.0 / (1.0 + ggx_lambda(ax_, ay_, wox, woy, woz, beckmann)
               + ggx_lambda(ax_, ay_, mx, my, mz, beckmann))
    ci = torch.abs(mz)
    co = torch.abs(woz)
    mic_base = d * g / torch.clamp_min(4.0 * ci * co, 1e-20)
    cos_ih = dot3(mx, my, mz, hx, hy, hz)
    kd_on = _on(attr["abr"], attr["abg"], attr["abb"])
    ks_on = _on(attr["kr"], attr["kg"], attr["kb"])
    pdf_lam = torch.abs(cz) * INV_PI

    sel = mat == float(T.MAT_PLASTIC)
    fr = fr_dielectric(cos_ih, 1.5 * ones, ones)
    nact = kd_on.float() + ks_on.float()
    j = torch.floor(ul * nact)
    pick_lam = kd_on & (j == 0.0)
    pick_mic = ks_on & (j == kd_on.float())
    ok_mic = pick_mic & ~mic_bad
    pf = [torch.where(pick_lam, ab * INV_PI, 0.0)
          + torch.where(ok_mic, k * fr * mic_base, 0.0)
          for ab, k in ((attr["abr"], attr["kr"]), (attr["abg"], attr["kg"]),
                        (attr["abb"], attr["kb"]))]
    pp = (torch.where(pick_lam, pdf_lam, 0.0)
          + torch.where(ok_mic, pdf_mic, 0.0)) / torch.clamp_min(nact, 1.0)
    wix = torch.where(sel, torch.where(pick_lam, cx, mx), wix)
    wiy = torch.where(sel, torch.where(pick_lam, cy, my), wiy)
    wiz = torch.where(sel, torch.where(pick_lam, cz, mz), wiz)
    f_r = torch.where(sel, pf[0], f_r)
    f_g = torch.where(sel, pf[1], f_g)
    f_b = torch.where(sel, pf[2], f_b)
    pdf = torch.where(sel, pp, pdf)

    sel = mat == float(T.MAT_UBER)
    eta = attr["ir"]
    fr = fr_dielectric(cos_ih, ones, eta)
    op_on = _on(attr["opr"], attr["opg"], attr["opb"])
    kr_on = _on(attr["krr"], attr["krg"], attr["krb"])
    kt_on = _on(attr["ktr"], attr["ktg"], attr["ktb"])
    ind = [x.float() for x in (op_on, kd_on, ks_on, kr_on, kt_on)]
    nact = ind[0] + ind[1] + ind[2] + ind[3] + ind[4]
    j = torch.floor(ul * nact)
    rank1 = ind[0]
    rank2 = rank1 + ind[1]
    rank3 = rank2 + ind[2]
    rank4 = rank3 + ind[3]
    pick_op = op_on & (j == 0.0)
    pick_lam = kd_on & (j == rank1)
    pick_mic = ks_on & (j == rank2)
    pick_kr = kr_on & (j == rank3)
    pick_kt = kt_on & (j == rank4)
    inv_co = 1.0 / torch.clamp_min(torch.abs(woz), 1e-9)
    fr_kr = fr_dielectric(woz, ones, eta)
    nz_ = torch.where(woz > 0.0, 1.0, -1.0)
    eta_ratio = torch.where(woz > 0.0, 1.0 / torch.clamp_min(eta, 1e-9), eta)
    cos_i = nz_ * woz
    sin2_t = eta_ratio * eta_ratio * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    ok_t = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    tx = -wox * eta_ratio
    ty = -woy * eta_ratio
    tz = -woz * eta_ratio + (eta_ratio * cos_i - cos_t) * nz_
    fr_kt = fr_dielectric(tz, ones, eta)
    inv_ct = 1.0 / torch.clamp_min(torch.abs(tz), 1e-9)
    ok_mic = pick_mic & ~mic_bad
    ok_kt = pick_kt & ok_t

    def pick_dir(o_op, o_lam, o_mic, o_kr, o_kt):
        return torch.where(pick_op, o_op, torch.where(
            pick_lam, o_lam, torch.where(
                pick_mic, o_mic, torch.where(pick_kr, o_kr, o_kt))))

    def lobe_f(ch_op, ch_ab, ch_k, ch_kr, ch_kt):
        return (torch.where(pick_op, ch_op * inv_co, 0.0)
                + torch.where(pick_lam, ch_ab * INV_PI, 0.0)
                + torch.where(ok_mic, ch_k * fr * mic_base, 0.0)
                + torch.where(pick_kr, ch_kr * fr_kr * inv_co, 0.0)
                + torch.where(ok_kt, ch_kt * (1.0 - fr_kt) * inv_ct, 0.0))

    up = (torch.where(pick_op | pick_kr, 1.0, 0.0)
          + torch.where(pick_lam, pdf_lam, 0.0)
          + torch.where(ok_mic, pdf_mic, 0.0)
          + torch.where(ok_kt, 1.0, 0.0)) / torch.clamp_min(nact, 1.0)
    wix = torch.where(sel, pick_dir(-wox, cx, mx, -wox, tx), wix)
    wiy = torch.where(sel, pick_dir(-woy, cy, my, -woy, ty), wiy)
    wiz = torch.where(sel, pick_dir(-woz, cz, mz, woz, tz), wiz)
    f_r = torch.where(sel, lobe_f(attr["opr"], attr["abr"], attr["kr"],
                                  attr["krr"], attr["ktr"]), f_r)
    f_g = torch.where(sel, lobe_f(attr["opg"], attr["abg"], attr["kg"],
                                  attr["krg"], attr["ktg"]), f_g)
    f_b = torch.where(sel, lobe_f(attr["opb"], attr["abb"], attr["kb"],
                                  attr["krb"], attr["ktb"]), f_b)
    pdf = torch.where(sel, up, pdf)
    return wix, wiy, wiz, f_r, f_g, f_b, pdf


def is_diffuse(attr):
    """Bsdf::contains(DIFFUSE) per lane: always for matte, metal and
    substrate; for plastic and uber only when a Kd or Ks lobe exists."""
    mat = attr["mat"]
    d = ((mat == float(T.MAT_MATTE)) | (mat == float(T.MAT_METAL))
         | (mat == float(T.MAT_SUBSTRATE)))
    lobes = (_on(attr["abr"], attr["abg"], attr["abb"])
             | _on(attr["kr"], attr["kg"], attr["kb"]))
    multi = (mat == float(T.MAT_PLASTIC)) | (mat == float(T.MAT_UBER))
    return d | (multi & lobes)


# -- the XLA engine's lobe slots (rene_tpu/ops/bsdf.py) ---------------------
# Lobe slots per material (material.rs): matte: lambertian | glass:
# fresnel-specular | substrate: fresnel-blend | metal: microfacet +
# conductor | mirror: specular + noop | plastic: lambertian + microfacet
# (dielectric 1.5 -> 1.0) | uber: opacity transmission, lambertian,
# microfacet, specular reflection, specular transmission, each where its
# weight is not zero.

_KIND_OF = {
    T.BXDF_LAMBERTIAN: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_FRESNEL_SPECULAR: T.KIND_REFLECTION | T.KIND_TRANSMISSION,
    T.BXDF_FRESNEL_BLEND: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_MICROFACET_REFLECTION: T.KIND_REFLECTION | T.KIND_DIFFUSE,
    T.BXDF_SPECULAR_REFLECTION: T.KIND_REFLECTION,
    T.BXDF_SPECULAR_TRANSMISSION: T.KIND_TRANSMISSION,
}

_MAT_LOBES = {
    T.MAT_NONE: (),
    T.MAT_MATTE: (T.BXDF_LAMBERTIAN,),
    T.MAT_GLASS: (T.BXDF_FRESNEL_SPECULAR,),
    T.MAT_SUBSTRATE: (T.BXDF_FRESNEL_BLEND,),
    T.MAT_METAL: (T.BXDF_MICROFACET_REFLECTION,),
    T.MAT_MIRROR: (T.BXDF_SPECULAR_REFLECTION,),
    T.MAT_UBER: (T.BXDF_SPECULAR_TRANSMISSION, T.BXDF_LAMBERTIAN,
                 T.BXDF_MICROFACET_REFLECTION, T.BXDF_SPECULAR_REFLECTION),
    T.MAT_PLASTIC: (T.BXDF_LAMBERTIAN, T.BXDF_MICROFACET_REFLECTION),
}

_MAT_FRESNELS = {
    T.MAT_METAL: (T.FRESNEL_CONDUCTOR,),
    T.MAT_MIRROR: (T.FRESNEL_NOOP,),
    T.MAT_PLASTIC: (T.FRESNEL_DIELECTRIC,),
    T.MAT_UBER: (T.FRESNEL_DIELECTRIC,),
}

# texture payload slots each material reads (0..3 = u0.xyzw, 4..6 =
# u1.x/z/w)
_MAT_FETCHES = {
    T.MAT_NONE: (),
    T.MAT_MATTE: (0,),
    T.MAT_GLASS: (),
    T.MAT_SUBSTRATE: (0, 1, 2, 3),
    T.MAT_METAL: (0, 1, 2, 3),
    T.MAT_MIRROR: (0,),
    T.MAT_UBER: (0, 1, 2, 3, 4, 5, 6),
    T.MAT_PLASTIC: (0, 1, 3),
}


def lobe_types_for(config):
    out = []
    for mt in config.mat_types:
        for lt in _MAT_LOBES[mt]:
            if lt not in out:
                out.append(lt)
    return tuple(sorted(out))


def fresnel_types_for(config):
    out = []
    for mt in config.mat_types:
        for ft in _MAT_FRESNELS.get(mt, ()):
            if ft not in out:
                out.append(ft)
    return tuple(sorted(out))


def _kind_lookup(lobe_type):
    out = torch.zeros_like(lobe_type)
    for lt, kind in _KIND_OF.items():
        out = torch.where(lobe_type == lt, kind, out)
    return out


def _empty_slot(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "type": torch.zeros((n,), dtype=torch.int64, device=device),
        "active": torch.zeros((n,), dtype=torch.bool, device=device),
        "v0": V3(z, z, z),
        "v1": V3(z, z, z),
        "ax": z,
        "ay": z,
        "fr_type": torch.full((n,), T.FRESNEL_NOOP, dtype=torch.int64,
                              device=device),
        "fr_eta_i": V3.ones((n,), device),
        "fr_eta_t": V3.ones((n,), device),
        "fr_k": V3(z, z, z),
    }


def _set(slot, mask, ltype, v0=None, v1=None, ax=None, ay=None,
         fr_type=None, fr_eta_i=None, fr_eta_t=None, fr_k=None):
    slot["active"] = slot["active"] | mask
    slot["type"] = torch.where(mask, ltype, slot["type"])
    for key, val in (("v0", v0), ("v1", v1), ("fr_eta_i", fr_eta_i),
                     ("fr_eta_t", fr_eta_t), ("fr_k", fr_k)):
        if val is not None:
            slot[key] = v3.where(mask, val, slot[key])
    for key, val in (("ax", ax), ("ay", ay), ("fr_type", fr_type)):
        if val is not None:
            slot[key] = torch.where(mask, val, slot[key])


def compute_bsdf(buffers, mat_idx, uv, config) -> List[Dict]:
    """The lobe slots of each ray's material. mat_idx (N,), uv (u, v)."""
    n = mat_idx.shape[0]
    dev = mat_idx.device
    mats = set(config.mat_types)
    mtype = at(buffers["mat_type"], mat_idx)
    u0 = at(buffers["mat_u0"], mat_idx)
    u1 = at(buffers["mat_u1"], mat_idx)
    mv = at(buffers["mat_v0"], mat_idx)
    v0x = mv[:, 0]

    need = set()
    for mt in mats:
        need.update(_MAT_FETCHES[mt])

    def fetch(slot_id, idx):
        if slot_id not in need:
            return V3.zeros((n,), dev)
        return tex_color(buffers, idx, uv, config)

    t_u0x = fetch(0, u0[:, 0])
    t_u0y = fetch(1, u0[:, 1])
    t_u0z = fetch(2, u0[:, 2])
    t_u0w = fetch(3, u0[:, 3])
    t_u1x = fetch(4, u1[:, 0])
    t_u1z = fetch(5, u1[:, 2])
    t_u1w = fetch(6, u1[:, 3])

    slots = [_empty_slot(n, dev) for _ in range(config.max_lobes)]
    one3 = V3.ones((n,), dev)

    def remap_alpha(flag, ru, rv):
        on = flag != 0
        return (torch.where(on, mf.roughness_to_alpha(ru), ru),
                torch.where(on, mf.roughness_to_alpha(rv), rv))

    if T.MAT_MATTE in mats:  # material.rs:117-136
        _set(slots[0], mtype == T.MAT_MATTE, T.BXDF_LAMBERTIAN, v0=t_u0x)

    if T.MAT_GLASS in mats:  # ir in the lobe's v0.x (material.rs:332-351)
        zn = torch.zeros_like(v0x)
        _set(slots[0], mtype == T.MAT_GLASS, T.BXDF_FRESNEL_SPECULAR,
             v0=V3(v0x, zn, zn))

    if T.MAT_SUBSTRATE in mats:  # material.rs:187-226
        ax, ay = remap_alpha(u1[:, 0], t_u0z.x, t_u0w.x)
        _set(slots[0], mtype == T.MAT_SUBSTRATE, T.BXDF_FRESNEL_BLEND,
             v0=t_u0x, v1=t_u0y, ax=ax, ay=ay)

    if T.MAT_METAL in mats:  # material.rs:278-317
        ax, ay = remap_alpha(u1[:, 0], t_u0z.x, t_u0w.x)
        # mat_v0.xyz scales the conductor's response (0 reads 1)
        fs = V3(torch.where(mv[:, 0] == 0.0, 1.0, mv[:, 0]),
                torch.where(mv[:, 1] == 0.0, 1.0, mv[:, 1]),
                torch.where(mv[:, 2] == 0.0, 1.0, mv[:, 2]))
        _set(slots[0], mtype == T.MAT_METAL, T.BXDF_MICROFACET_REFLECTION,
             v0=fs, ax=ax, ay=ay, fr_type=T.FRESNEL_CONDUCTOR,
             fr_eta_i=one3, fr_eta_t=t_u0x, fr_k=t_u0y)

    if T.MAT_MIRROR in mats:  # material.rs:362-383
        _set(slots[0], mtype == T.MAT_MIRROR, T.BXDF_SPECULAR_REFLECTION,
             v0=t_u0x, fr_type=T.FRESNEL_NOOP)

    if T.MAT_PLASTIC in mats:  # material.rs:679-707; dielectric 1.5 -> 1
        is_pl = mtype == T.MAT_PLASTIC
        a = torch.where(u1[:, 2] != 0, mf.roughness_to_alpha(t_u0w.x),
                        t_u0w.x)
        _set(slots[0], is_pl & t_u0x.any_nonzero(), T.BXDF_LAMBERTIAN,
             v0=t_u0x)
        _set(slots[1], is_pl & t_u0y.any_nonzero(),
             T.BXDF_MICROFACET_REFLECTION, v0=t_u0y, ax=a, ay=a,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3 * 1.5,
             fr_eta_t=one3)

    if T.MAT_UBER in mats:  # material.rs:578-630
        is_uber = mtype == T.MAT_UBER
        eta = v0x
        eta3 = V3(eta, eta, eta)
        op = t_u1x
        t_op = 1.0 - op
        kr = op * t_u0z
        kt = op * t_u0w
        ax, ay = remap_alpha(u1[:, 1], t_u1z.x, t_u1w.x)
        one_s = torch.ones_like(eta)
        _set(slots[0], is_uber & t_op.any_nonzero(),
             T.BXDF_SPECULAR_TRANSMISSION, v0=t_op,
             v1=V3(one_s, one_s, one_s), fr_type=T.FRESNEL_DIELECTRIC,
             fr_eta_i=one3, fr_eta_t=one3)
        _set(slots[1], is_uber & t_u0x.any_nonzero(), T.BXDF_LAMBERTIAN,
             v0=t_u0x)
        _set(slots[2], is_uber & t_u0y.any_nonzero(),
             T.BXDF_MICROFACET_REFLECTION, v0=t_u0y, ax=ax, ay=ay,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)
        _set(slots[3], is_uber & kr.any_nonzero(),
             T.BXDF_SPECULAR_REFLECTION, v0=kr,
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)
        _set(slots[4], is_uber & kt.any_nonzero(),
             T.BXDF_SPECULAR_TRANSMISSION, v0=kt,
             v1=V3(one_s, eta, torch.zeros_like(eta)),
             fr_type=T.FRESNEL_DIELECTRIC, fr_eta_i=one3, fr_eta_t=eta3)

    return slots


def material_albedo(buffers, mat_idx, uv, config) -> V3:
    """EnumMaterial::albedo, the albedo AOV (material.rs:719-736)."""
    mtype = at(buffers["mat_type"], mat_idx)
    u0 = at(buffers["mat_u0"], mat_idx)
    t_u0x = tex_color(buffers, u0[:, 0], uv, config)
    out = v3.where((mtype == T.MAT_MATTE) | (mtype == T.MAT_SUBSTRATE)
                   | (mtype == T.MAT_MIRROR) | (mtype == T.MAT_UBER)
                   | (mtype == T.MAT_PLASTIC), t_u0x, 0.0)
    if T.MAT_METAL in config.mat_types:
        t_u0y = tex_color(buffers, u0[:, 1], uv, config)
        out = v3.where(mtype == T.MAT_METAL, t_u0y, out)
    return out


def _refract(wi: V3, n: V3, eta_ratio):
    """(ok, wt): wi refracted about n (bxdf.rs:121-136)."""
    cos_i = n.dot(wi)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wt = -wi * eta_ratio + n * (eta_ratio * cos_i - cos_t)
    return ok, wt


def _schlick(rs: V3, cos_theta) -> V3:
    v = 1.0 - cos_theta
    v5 = (v * v) * (v * v) * v
    return rs + (1.0 - rs) * v5


def _pow5(x):
    return (x * x) * (x * x) * x


def _blend_f(slot, wo: V3, wi: V3) -> V3:
    """FresnelBlend::f (bxdf.rs:266-290)."""
    rd = slot["v0"]
    rs = slot["v1"]
    diffuse = (rd * (1.0 - rs) * (28.0 / (23.0 * math.pi))
               * (1.0 - _pow5(1.0 - 0.5 * v3.abs_cos_theta(wi)))
               * (1.0 - _pow5(1.0 - 0.5 * v3.abs_cos_theta(wo))))
    wh_raw = wi + wo
    degenerate = wh_raw.length_squared() < 1e-18
    wh = wh_raw.normalized()
    denom = (4.0 * torch.abs(wi.dot(wh))
             * torch.maximum(v3.abs_cos_theta(wi), v3.abs_cos_theta(wo)))
    spec = _schlick(rs, wi.dot(wh)) \
        * (mf.tr_d(slot["ax"], slot["ay"], wh) / torch.clamp_min(denom,
                                                                1e-20))
    return v3.where(degenerate, 0.0, diffuse + spec)


def _microfacet_f(slot, wo: V3, wi: V3, fr_types) -> V3:
    """MicrofacetReflection::f (bxdf.rs:361-383)."""
    ci = v3.abs_cos_theta(wi)
    co = v3.abs_cos_theta(wo)
    wh_raw = wi + wo
    bad = (ci == 0.0) | (co == 0.0) | (wh_raw.length_squared() < 1e-18)
    wh = wh_raw.normalized()
    wh = v3.where(wh.z < 0.0, -wh, wh)      # face_forward(wh, +z)
    f_term = fr.evaluate(slot["fr_type"], slot["fr_eta_i"],
                         slot["fr_eta_t"], slot["fr_k"], wi.dot(wh),
                         fr_types)
    val = slot["v0"] * f_term * (
        mf.tr_d(slot["ax"], slot["ay"], wh)
        * mf.tr_g(slot["ax"], slot["ay"], wo, wi)
        / torch.clamp_min(4.0 * ci * co, 1e-20))
    return v3.where(bad, 0.0, val)


def _slot_f(slot, wo: V3, wi: V3, lobe_types, fr_types) -> V3:
    t = slot["type"]
    out = V3.zeros(t.shape, t.device)
    if T.BXDF_LAMBERTIAN in lobe_types:
        out = v3.where(t == T.BXDF_LAMBERTIAN, slot["v0"] * INV_PI, out)
    if T.BXDF_FRESNEL_BLEND in lobe_types:
        out = v3.where(t == T.BXDF_FRESNEL_BLEND, _blend_f(slot, wo, wi),
                       out)
    if T.BXDF_MICROFACET_REFLECTION in lobe_types:
        out = v3.where(t == T.BXDF_MICROFACET_REFLECTION,
                       _microfacet_f(slot, wo, wi, fr_types), out)
    return out


def _slot_pdf(slot, wo: V3, wi: V3, lobe_types):
    t = slot["type"]
    same = v3.same_hemisphere(wo, wi)
    out = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    if T.BXDF_LAMBERTIAN in lobe_types:
        lam = torch.where(same, v3.abs_cos_theta(wi) * INV_PI, 0.0)
        out = torch.where(t == T.BXDF_LAMBERTIAN, lam, out)
    if (T.BXDF_FRESNEL_BLEND in lobe_types
            or T.BXDF_MICROFACET_REFLECTION in lobe_types):
        wh = (wo + wi).normalized()
        pdf_wh = mf.tr_pdf(slot["ax"], slot["ay"], wo, wh)
        denom = torch.clamp_min(4.0 * wo.dot(wh), 1e-20)
        if T.BXDF_FRESNEL_BLEND in lobe_types:
            blend = torch.where(same, 0.5 * (v3.abs_cos_theta(wi) * INV_PI
                                             + pdf_wh / denom), 0.0)
            out = torch.where(t == T.BXDF_FRESNEL_BLEND, blend, out)
        if T.BXDF_MICROFACET_REFLECTION in lobe_types:
            micro = torch.where(same, pdf_wh / denom, 0.0)
            out = torch.where(t == T.BXDF_MICROFACET_REFLECTION, micro, out)
    return out


def sample_chosen(slot, wo: V3, u_coin, u1, u2, lobe_types, fr_types):
    """Sample the chosen slot; the pdf is not yet divided by the lobe
    count. The sample_f of bxdf.rs with one budget of three draws."""
    t = slot["type"]
    n = t.shape[0]
    dev = t.device
    wi = V3.zeros((n,), dev)
    f = V3.zeros((n,), dev)
    pdf = torch.zeros((n,), dtype=torch.float32, device=dev)

    if (T.BXDF_LAMBERTIAN in lobe_types
            or T.BXDF_FRESNEL_BLEND in lobe_types):
        zc = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
        phi = TWO_PI * u1
        r2s = torch.sqrt(u2)
        cos_dir = V3(torch.cos(phi) * r2s, torch.sin(phi) * r2s,
                     torch.where(wo.z < 0.0, -zc, zc))

    if (T.BXDF_FRESNEL_BLEND in lobe_types
            or T.BXDF_MICROFACET_REFLECTION in lobe_types):
        wh = mf.tr_sample_wh(slot["ax"], slot["ay"], wo, u1, u2)

    if (T.BXDF_FRESNEL_SPECULAR in lobe_types
            or T.BXDF_SPECULAR_REFLECTION in lobe_types):
        wi_spec = V3(-wo.x, -wo.y, wo.z)

    if (T.BXDF_FRESNEL_SPECULAR in lobe_types
            or T.BXDF_SPECULAR_TRANSMISSION in lobe_types):
        zn = torch.zeros((n,), dtype=torch.float32, device=dev)
        n_vec = V3(zn, zn, torch.where(wo.z > 0.0, 1.0, -1.0))

    if T.BXDF_LAMBERTIAN in lobe_types:  # bxdf.rs:91-105
        sel = t == T.BXDF_LAMBERTIAN
        lam_pdf = torch.where(v3.same_hemisphere(wo, cos_dir),
                              v3.abs_cos_theta(cos_dir) * INV_PI, 0.0)
        wi = v3.where(sel, cos_dir, wi)
        f = v3.where(sel, slot["v0"] * INV_PI, f)
        pdf = torch.where(sel, lam_pdf, pdf)

    if T.BXDF_FRESNEL_SPECULAR in lobe_types:  # bxdf.rs:193-226
        sel = t == T.BXDF_FRESNEL_SPECULAR
        ir = slot["v0"].x
        f_diel = fr.fr_dielectric(v3.cos_theta(wo), torch.ones_like(ir), ir)
        take_refl = u_coin < f_diel
        eta_ratio = torch.where(v3.cos_theta(wo) > 0.0,
                                1.0 / torch.clamp_min(ir, 1e-9), ir)
        ok_t, fs_wi_t = _refract(wo, n_vec, eta_ratio)
        fs_wi = v3.where(take_refl, wi_spec, fs_wi_t)
        fs_val = torch.where(
            take_refl,
            f_diel / torch.clamp_min(v3.abs_cos_theta(wi_spec), 1e-9),
            (1.0 - f_diel) / torch.clamp_min(v3.abs_cos_theta(fs_wi_t),
                                             1e-9))
        fs_pdf = torch.where(take_refl, f_diel,
                             torch.where(ok_t, 1.0 - f_diel, 0.0))
        wi = v3.where(sel, fs_wi, wi)
        f = v3.where(sel, V3(fs_val, fs_val, fs_val), f)
        pdf = torch.where(sel, fs_pdf, pdf)

    if T.BXDF_FRESNEL_BLEND in lobe_types:  # bxdf.rs:292-317
        sel = t == T.BXDF_FRESNEL_BLEND
        take_cos = u_coin < 0.5
        wi_sp = v3.reflect(wo, wh)
        fb_wi = v3.where(take_cos, cos_dir, wi_sp)
        fb_bad = ~take_cos & ~v3.same_hemisphere(wo, wi_sp)
        fb_f = v3.where(fb_bad, 0.0, _blend_f(slot, wo, fb_wi))
        fb_wh = (wo + fb_wi).normalized()
        fb_pdf_wh = mf.tr_pdf(slot["ax"], slot["ay"], wo, fb_wh)
        fb_pdf = torch.where(
            fb_bad | ~v3.same_hemisphere(wo, fb_wi), 0.0,
            0.5 * (v3.abs_cos_theta(fb_wi) * INV_PI
                   + fb_pdf_wh / torch.clamp_min(4.0 * wo.dot(fb_wh),
                                                 1e-20)))
        wi = v3.where(sel, fb_wi, wi)
        f = v3.where(sel, fb_f, f)
        pdf = torch.where(sel, fb_pdf, pdf)

    if T.BXDF_MICROFACET_REFLECTION in lobe_types:  # bxdf.rs:385-406
        sel = t == T.BXDF_MICROFACET_REFLECTION
        mr_wi = v3.reflect(wo, wh)
        mr_bad = ((wo.z == 0.0) | (wo.dot(wh) < 0.0)
                  | ~v3.same_hemisphere(wo, mr_wi))
        mr_pdf = torch.where(
            mr_bad, 0.0,
            mf.tr_pdf(slot["ax"], slot["ay"], wo, wh)
            / torch.clamp_min(4.0 * wo.dot(wh), 1e-20))
        mr_f = v3.where(mr_bad, 0.0, _microfacet_f(slot, wo, mr_wi,
                                                   fr_types))
        wi = v3.where(sel, mr_wi, wi)
        f = v3.where(sel, mr_f, f)
        pdf = torch.where(sel, mr_pdf, pdf)

    if T.BXDF_SPECULAR_REFLECTION in lobe_types:  # bxdf.rs:437-443
        sel = t == T.BXDF_SPECULAR_REFLECTION
        sr_f = (fr.evaluate(slot["fr_type"], slot["fr_eta_i"],
                            slot["fr_eta_t"], slot["fr_k"],
                            v3.cos_theta(wi_spec), fr_types) * slot["v0"]
                * (1.0 / torch.clamp_min(v3.abs_cos_theta(wi_spec), 1e-9)))
        wi = v3.where(sel, wi_spec, wi)
        f = v3.where(sel, sr_f, f)
        pdf = torch.where(sel, 1.0, pdf)

    if T.BXDF_SPECULAR_TRANSMISSION in lobe_types:  # bxdf.rs:481-512
        sel = t == T.BXDF_SPECULAR_TRANSMISSION
        eta_a = slot["v1"].x
        eta_b = slot["v1"].y
        entering = v3.cos_theta(wo) > 0.0
        ei = torch.where(entering, eta_a, eta_b)
        et = torch.where(entering, eta_b, eta_a)
        ok, st_wi = _refract(wo, n_vec, ei / torch.clamp_min(et, 1e-9))
        st_fr = fr.fr_dielectric(v3.cos_theta(st_wi), eta_a, eta_b)
        st_f = v3.where(
            ok,
            slot["v0"] * ((1.0 - st_fr)
                          / torch.clamp_min(v3.abs_cos_theta(st_wi), 1e-9)),
            0.0)
        wi = v3.where(sel, st_wi, wi)
        f = v3.where(sel, st_f, f)
        pdf = torch.where(sel, torch.where(ok, 1.0, 0.0), pdf)

    return wi, f, pdf


def bsdf_contains(slots, kind):
    """Bsdf::contains (reflection.rs:268-283)."""
    out = torch.zeros_like(slots[0]["active"])
    for s in slots:
        out = out | (s["active"] & ((_kind_lookup(s["type"]) & kind) != 0))
    return out


def bsdf_num_lobes(slots):
    num = slots[0]["active"].long()
    for s in slots[1:]:
        num = num + s["active"].long()
    return num


def bsdf_f(slots, onb: v3.Onb, ng: V3, wo_world: V3, wi_world: V3,
           config) -> V3:
    """Bsdf::f (reflection.rs:286-311): the lobes on the reflecting or
    transmitting side of the geometric normal, summed."""
    lobe_types = lobe_types_for(config)
    fr_types = fresnel_types_for(config)
    wo = onb.to_local(wo_world)
    wi = onb.to_local(wi_world)
    reflect_side = (wi_world.dot(ng) * wo_world.dot(ng)) > 0.0
    total = V3.zeros(wo.x.shape, wo.x.device)
    for s in slots:
        kinds = _kind_lookup(s["type"])
        match = torch.where(reflect_side, (kinds & T.KIND_REFLECTION) != 0,
                            (kinds & T.KIND_TRANSMISSION) != 0)
        val = _slot_f(s, wo, wi, lobe_types, fr_types)
        total = total + v3.where(match & s["active"], val, 0.0)
    return v3.where(wo.z == 0.0, 0.0, total)


def bsdf_pdf(slots, onb: v3.Onb, wo_world: V3, wi_world: V3, config):
    """Bsdf::pdf (reflection.rs:328-342): the mean over active lobes."""
    lobe_types = lobe_types_for(config)
    wo = onb.to_local(wo_world)
    wi = onb.to_local(wi_world)
    total = torch.zeros_like(wo.x)
    for s in slots:
        total = total + torch.where(s["active"],
                                    _slot_pdf(s, wo, wi, lobe_types), 0.0)
    num = torch.clamp_min(bsdf_num_lobes(slots), 1)
    return total / num.to(torch.float32)


def bsdf_sample_f(slots, onb: v3.Onb, wo_world: V3, state, config):
    """Bsdf::sample_f (reflection.rs:313-326): an active lobe chosen
    uniformly. Returns (wi_world, f, pdf, state), the pdf divided by the
    lobe count; all zero where no lobe is active."""
    lobe_types = lobe_types_for(config)
    fr_types = fresnel_types_for(config)
    wo = onb.to_local(wo_world)
    num = bsdf_num_lobes(slots)

    if len(slots) == 1:
        chosen = slots[0]
    else:
        uidx, state = rng.next_u32(state)
        j = uidx % torch.clamp_min(num, 1)
        # the j-th active slot, by a running rank
        chosen = dict(slots[0])
        rank = slots[0]["active"].long() - 1
        for s in slots[1:]:
            rank = rank + s["active"].long()
            take = s["active"] & (rank == j)
            for k in chosen:
                if isinstance(chosen[k], V3):
                    chosen[k] = v3.where(take, s[k], chosen[k])
                else:
                    chosen[k] = torch.where(take, s[k], chosen[k])

    u_coin, state = rng.next_f32(state)
    u1, state = rng.next_f32(state)
    u2, state = rng.next_f32(state)
    wi, f, pdf = sample_chosen(chosen, wo, u_coin, u1, u2, lobe_types,
                               fr_types)
    pdf = pdf / torch.clamp_min(num, 1).to(torch.float32)
    empty = num == 0
    wi_world = onb.to_world(wi)
    return (v3.where(empty, 0.0, wi_world), v3.where(empty, 0.0, f),
            torch.where(empty, 0.0, pdf), state)

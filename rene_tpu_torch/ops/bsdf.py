"""BSDF evaluation and sampling of the megakernel, for all 8 material types
with solid textures.

Counterpart of pallas_path.py `bsdf_eval` (:3685-3832), `bsdf_sample`
(:3834-4108) and `is_diffuse` (:4113-4130). The TPU kernel selects the
material's constants per primitive from immediates; here they are
gathered per lane from the material table (`gather_material`), and every
material's branch is evaluated under a `where` on the lane's type, as the
JAX kernel does. Vectors are in the shading frame (z = normal).
"""
from __future__ import annotations

import math

import torch

from ..scene import types as T

from ..scene import pack as P
from .fresnel import fr_conductor_ch, fr_dielectric
from .microfacet import ggx_d, ggx_lambda, sample_wh, wh_pdf
from .vec3 import dot3, normalize3

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

"""Frozen copy of rene_tpu_torch/ops/microfacet.py at commit ed2dcef.

Microfacet distribution of the megakernel (pallas_path.py:3557-3684).

GGX (Trowbridge-Reitz) by default; `beckmann=True` is the
`RENE_MF_DIST=beckmann` switch (:3563), which swaps D, the Smith lambda
and the sampler for Beckmann's. The caller reads the environment once
and passes the flag down, as the JAX kernel reads it at build time.

The XLA engine's forms of rene_tpu/ops/microfacet.py follow, over V3
vectors (`roughness_to_alpha`, `tr_d`, `tr_lambda`, `tr_g`, `tr_g1`,
`tr_sample_wh`, `tr_pdf`).
"""
from __future__ import annotations

import math
import os

import torch

from . import vec3 as v3
from .vec3 import V3, dot3, normalize3

TWO_PI = 2.0 * math.pi


def ggx_d(ax_, ay_, hx, hy, hz, beckmann=False):
    c2 = hz * hz
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    tan2 = s2 / torch.clamp_min(c2, 1e-20)
    sin_t = torch.sqrt(s2)
    cphi = torch.where(sin_t == 0.0, 1.0, torch.clamp(
        hx / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    sphi = torch.where(sin_t == 0.0, 0.0, torch.clamp(
        hy / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    e = (cphi * cphi / torch.clamp_min(ax_ * ax_, 1e-20)
         + sphi * sphi / torch.clamp_min(ay_ * ay_, 1e-20)) * tan2
    if beckmann:
        d = torch.exp(-torch.clamp_max(e, 80.0)) / torch.clamp_min(
            math.pi * ax_ * ay_ * c2 * c2, 1e-30)
    else:
        q = 1.0 + e
        d = 1.0 / torch.clamp_min(math.pi * ax_ * ay_ * c2 * c2 * (q * q),
                                  1e-30)
    return torch.where(tan2 < 3e38, d, 0.0)


def ggx_lambda(ax_, ay_, x, y, z, beckmann=False):
    """Exact GGX Smith lambda (Beckmann: pbrt's rational fit)."""
    c2 = z * z
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    abs_tan = torch.sqrt(s2) / torch.clamp_min(torch.abs(z), 1e-20)
    sin_t = torch.sqrt(s2)
    cphi = torch.where(sin_t == 0.0, 1.0, torch.clamp(
        x / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    sphi = torch.where(sin_t == 0.0, 0.0, torch.clamp(
        y / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    alpha = torch.sqrt(cphi * cphi * ax_ * ax_ + sphi * sphi * ay_ * ay_)
    if beckmann:
        a = 1.0 / torch.clamp_min(alpha * abs_tan, 1e-9)
        lam = torch.where(
            a >= 1.6, 0.0,
            (1.0 - 1.259 * a + 0.396 * a * a)
            / torch.clamp_min(3.535 * a + 2.181 * a * a, 1e-9))
        return torch.where(abs_tan < 3e38, lam, 0.0)
    at = alpha * abs_tan
    at2 = torch.clamp_max(at * at, 1e30)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + at2))


def wh_pdf(ax_, ay_, wox, woy, woz, hx, hy, hz, d, beckmann=False):
    """pdf of the sampled half vector: GGX visible normals
    (D G1(wo) |wo.wh| / |cos wo|) or Beckmann full normals (D |cos wh|)."""
    if beckmann:
        return d * torch.abs(hz)
    g1o = 1.0 / (1.0 + ggx_lambda(ax_, ay_, wox, woy, woz))
    return d * g1o * torch.abs(dot3(wox, woy, woz, hx, hy, hz)) \
        / torch.clamp_min(torch.abs(woz), 1e-9)


def beckmann_sample_wh(ax_, ay_, wx_, wy_, wz_, u1, u2):
    t = TWO_PI * u2
    rx = ax_ * torch.cos(t)
    ry = ay_ * torch.sin(t)
    rn = torch.sqrt(torch.clamp_min(rx * rx + ry * ry, 1e-30))
    cphi = rx / rn
    sphi = ry / rn
    logs = torch.log(torch.clamp_min(1.0 - u1, 1e-9))
    tan2 = -logs / torch.clamp_min(
        cphi * cphi / torch.clamp_min(ax_ * ax_, 1e-20)
        + sphi * sphi / torch.clamp_min(ay_ * ay_, 1e-20), 1e-20)
    cz = 1.0 / torch.sqrt(1.0 + tan2)
    sz = torch.sqrt(torch.clamp_min(1.0 - cz * cz, 0.0))
    hx, hy, hz = sz * cphi, sz * sphi, cz
    flip = wz_ < 0.0
    return (torch.where(flip, -hx, hx), torch.where(flip, -hy, hy),
            torch.where(flip, -hz, hz))


def ggx_sample_wh(ax_, ay_, wx_, wy_, wz_, u1, u2):
    """Visible-normal sampling (pbrt TrowbridgeReitzSample)."""
    flip = wz_ < 0.0
    sx = torch.where(flip, -wx_, wx_)
    sy = torch.where(flip, -wy_, wy_)
    sz = torch.where(flip, -wz_, wz_)
    stx, sty, stz = normalize3(ax_ * sx, ay_ * sy, sz)
    cos_t = stz
    r_s = torch.sqrt(u1 / torch.clamp_min(1.0 - u1, 1e-9))
    phi_s = TWO_PI * u2
    spec_x = r_s * torch.cos(phi_s)
    spec_y = r_s * torch.sin(phi_s)
    cc = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cc * cc, 0.0))
    tan_t = sin_t / torch.clamp_min(cc, 1e-9)
    a0 = 1.0 / torch.clamp_min(tan_t, 1e-9)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a0 * a0)))
    aa = 2.0 * u1 / torch.clamp_min(g1, 1e-9) - 1.0
    a2m1 = aa * aa - 1.0
    tmp = torch.clamp_max(
        1.0 / torch.where(torch.abs(a2m1) > 1e-12, a2m1, 1e-12), 1e10)
    bb = tan_t
    dd = torch.sqrt(torch.clamp_min(
        bb * bb * tmp * tmp - (aa * aa - bb * bb) * tmp, 0.0))
    sl1 = bb * tmp - dd
    sl2 = bb * tmp + dd
    slope_x = torch.where((aa < 0.0) | (sl2 > a0), sl1, sl2)
    sflip = torch.where(u2 > 0.5, 1.0, -1.0)
    u2f = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    zz = ((u2f * (u2f * (u2f * 0.27385 - 0.73369) + 0.46341))
          / (u2f * (u2f * (u2f * 0.093073 + 0.309420) - 1.0) + 0.597999))
    slope_y = sflip * zz * torch.sqrt(1.0 + slope_x * slope_x)
    sin_p = torch.where(sin_t == 0.0, 0.0, torch.clamp(
        sty / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    cos_p = torch.where(sin_t == 0.0, 1.0, torch.clamp(
        stx / torch.clamp_min(sin_t, 1e-20), -1.0, 1.0))
    slope_x2 = torch.where(cos_t > 0.9999, spec_x,
                           cos_p * slope_x - sin_p * slope_y)
    slope_y2 = torch.where(cos_t > 0.9999, spec_y,
                           sin_p * slope_x + cos_p * slope_y)
    hx, hy, hz = normalize3(-ax_ * slope_x2, -ay_ * slope_y2,
                            torch.ones_like(u1))
    return (torch.where(flip, -hx, hx), torch.where(flip, -hy, hy),
            torch.where(flip, -hz, hz))


def sample_wh(ax_, ay_, wx_, wy_, wz_, u1, u2, beckmann=False):
    if beckmann:
        return beckmann_sample_wh(ax_, ay_, wx_, wy_, wz_, u1, u2)
    return ggx_sample_wh(ax_, ay_, wx_, wy_, wz_, u1, u2)


# -- the XLA engine's forms (rene_tpu/ops/microfacet.py), over V3 ----------
# RENE_MF_DIST=beckmann swaps the distribution to Beckmann here too; it is
# read at every call, as the reference reads it at trace time.

PI = math.pi


def _beckmann():
    return os.environ.get("RENE_MF_DIST", "") == "beckmann"


def roughness_to_alpha(roughness):
    """pbrt's roughness remap (microfacet.rs:65-74)."""
    r = torch.clamp_min(roughness, 1e-3)
    x = torch.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def tr_d(ax, ay, wh: V3):
    """The GGX normal distribution (microfacet.rs:141-155)."""
    tan2 = v3.tan2_theta(wh)
    cos4 = v3.cos2_theta(wh) ** 2
    e = (v3.cos2_phi(wh) / torch.clamp_min(ax * ax, 1e-20)
         + v3.sin2_phi(wh) / torch.clamp_min(ay * ay, 1e-20)) * tan2
    if _beckmann():
        d = torch.exp(-torch.clamp_max(e, 80.0)) / torch.clamp_min(
            PI * ax * ay * cos4, 1e-30)
    else:
        d = 1.0 / torch.clamp_min(PI * ax * ay * cos4 * (1.0 + e) ** 2,
                                  1e-30)
    return torch.where(torch.isfinite(tan2) & torch.isfinite(d), d, 0.0)


def tr_lambda(ax, ay, w: V3):
    """The exact GGX Smith lambda (Beckmann: pbrt's rational fit)."""
    abs_tan = torch.abs(v3.tan_theta(w))
    alpha = torch.sqrt(v3.cos2_phi(w) * ax * ax + v3.sin2_phi(w) * ay * ay)
    if _beckmann():
        a = 1.0 / torch.clamp_min(alpha * abs_tan, 1e-9)
        lam = torch.where(
            a >= 1.6, 0.0,
            (1.0 - 1.259 * a + 0.396 * a * a)
            / torch.clamp_min(3.535 * a + 2.181 * a * a, 1e-9))
        return torch.where(torch.isfinite(abs_tan), lam, 0.0)
    at2 = (alpha * abs_tan) ** 2
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + at2))
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def tr_g(ax, ay, wo: V3, wi: V3):
    return 1.0 / (1.0 + tr_lambda(ax, ay, wo) + tr_lambda(ax, ay, wi))


def tr_g1(ax, ay, w: V3):
    return 1.0 / (1.0 + tr_lambda(ax, ay, w))


def _sample11(cos_theta, u1, u2):
    """Visible-normal slope sampling (pbrt TrowbridgeReitzSample11)."""
    r_s = torch.sqrt(u1 / torch.clamp_min(1.0 - u1, 1e-9))
    phi_s = TWO_PI * u2
    special_x = r_s * torch.cos(phi_s)
    special_y = r_s * torch.sin(phi_s)

    c = torch.clamp(cos_theta, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    tan_t = sin_t / torch.clamp_min(c, 1e-9)
    a0 = 1.0 / torch.clamp_min(tan_t, 1e-9)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a0 * a0)))

    a = 2.0 * u1 / torch.clamp_min(g1, 1e-9) - 1.0
    tmp = torch.clamp_max(1.0 / torch.where(
        torch.abs(a * a - 1.0) > 1e-12, a * a - 1.0, 1e-12), 1e10)
    b = tan_t
    d = torch.sqrt(torch.clamp_min(b * b * tmp * tmp - (a * a - b * b) * tmp,
                                   0.0))
    slope_x_1 = b * tmp - d
    slope_x_2 = b * tmp + d
    slope_x = torch.where((a < 0.0) | (slope_x_2 > a0), slope_x_1, slope_x_2)

    s = torch.where(u2 > 0.5, 1.0, -1.0)
    u2f = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = ((u2f * (u2f * (u2f * 0.27385 - 0.73369) + 0.46341))
         / (u2f * (u2f * (u2f * 0.093073 + 0.309420) - 1.0) + 0.597999))
    slope_y = s * z * torch.sqrt(1.0 + slope_x * slope_x)

    take_special = cos_theta > 0.9999
    return (torch.where(take_special, special_x, slope_x),
            torch.where(take_special, special_y, slope_y))


def tr_sample_wh(ax, ay, wo: V3, u1, u2) -> V3:
    """A visible microfacet normal (microfacet.rs:124-190)."""
    if _beckmann():
        return _beckmann_sample_wh(ax, ay, wo, u1, u2)
    flip = wo.z < 0.0
    w = v3.where(flip, -wo, wo)
    stretched = V3(ax * w.x, ay * w.y, w.z).normalized()
    sx, sy = _sample11(v3.cos_theta(stretched), u1, u2)
    cp = v3.cos_phi(stretched)
    sp = v3.sin_phi(stretched)
    slope_x = ax * (cp * sx - sp * sy)
    slope_y = ay * (sp * sx + cp * sy)
    wh = V3(-slope_x, -slope_y, torch.ones_like(slope_x)).normalized()
    return v3.where(flip, -wh, wh)


def _beckmann_sample_wh(ax, ay, wo: V3, u1, u2) -> V3:
    """Full-normal Beckmann sampling (pbrt Sample_wh, not visible)."""
    t = TWO_PI * u2
    rx = ax * torch.cos(t)
    ry = ay * torch.sin(t)
    rn = torch.sqrt(torch.clamp_min(rx * rx + ry * ry, 1e-30))
    cphi, sphi = rx / rn, ry / rn
    logs = torch.log(torch.clamp_min(1.0 - u1, 1e-9))
    tan2 = -logs / torch.clamp_min(
        cphi * cphi / torch.clamp_min(ax * ax, 1e-20)
        + sphi * sphi / torch.clamp_min(ay * ay, 1e-20), 1e-20)
    cz = 1.0 / torch.sqrt(1.0 + tan2)
    sz = torch.sqrt(torch.clamp_min(1.0 - cz * cz, 0.0))
    wh = V3(sz * cphi, sz * sphi, cz)
    return v3.where(wo.z < 0.0, -wh, wh)


def tr_pdf(ax, ay, wo: V3, wh: V3):
    """The visible-normal pdf of wh (microfacet.rs:192-194); under
    Beckmann, the full-normal pdf D |cos wh|."""
    if _beckmann():
        return tr_d(ax, ay, wh) * v3.abs_cos_theta(wh)
    return (tr_d(ax, ay, wh) * tr_g1(ax, ay, wo) * torch.abs(wo.dot(wh))
            / torch.clamp_min(v3.abs_cos_theta(wo), 1e-9))

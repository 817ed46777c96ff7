"""Frozen copy of rene_tpu_torch/ops/fresnel.py at commit ed2dcef.

Fresnel terms of the megakernel (pallas_path.py:3528-3555).

The same formulas as rene_tpu/ops/fresnel.py `fr_dielectric` and
`_fr_conductor_channel`. The XLA engine takes `fr_dielectric` as it is,
and its V3 forms `fr_conductor` and `evaluate` (EnumFresnel::evaluate)
follow below.
"""
from __future__ import annotations

import torch

from ..scene import types as T
from . import vec3 as v3
from .vec3 import V3


def fr_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel with the ray-side swap and TIR."""
    c = torch.clamp(cos_i, -1.0, 1.0)
    entering = c > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    c = torch.abs(c)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    sin_t = ei / et * sin_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    rp = ((et * c) - (ei * cos_t)) / torch.clamp_min(
        (et * c) + (ei * cos_t), 1e-20)
    rs = ((ei * c) - (et * cos_t)) / torch.clamp_min(
        (ei * c) + (et * cos_t), 1e-20)
    return torch.where(sin_t >= 1.0, 1.0, 0.5 * (rp * rp + rs * rs))


def fr_conductor_ch(c2, s2, eta, etk, c):
    """One channel of the conductor Fresnel term."""
    eta2 = eta * eta
    etk2 = etk * etk
    t0 = eta2 - etk2 - s2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * etk2, 0.0))
    t1 = a2b2 + c2
    a_ = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * c * a_
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)


# -- the XLA engine's forms (rene_tpu/ops/fresnel.py) -----------------------

def fr_conductor(cos_theta_i, eta_i: V3, eta_t: V3, k: V3) -> V3:
    """The conductor Fresnel term per channel (fresnel.rs:78-102)."""
    c = torch.clamp(cos_theta_i, -1.0, 1.0)
    c2 = c * c
    s2 = 1.0 - c2
    eta = eta_t / eta_i.map(lambda v: torch.clamp_min(v, 1e-20))
    eta_k = k / eta_i.map(lambda v: torch.clamp_min(v, 1e-20))
    return V3(fr_conductor_ch(c2, s2, eta.x, eta_k.x, c),
              fr_conductor_ch(c2, s2, eta.y, eta_k.y, c),
              fr_conductor_ch(c2, s2, eta.z, eta_k.z, c))


def evaluate(fr_type, eta_i: V3, eta_t: V3, k: V3, cos_i,
             types_present=(T.FRESNEL_CONDUCTOR, T.FRESNEL_NOOP,
                            T.FRESNEL_DIELECTRIC)) -> V3:
    """EnumFresnel::evaluate (fresnel.rs:161-171) for the Fresnel types
    the scene holds."""
    out = V3.ones(cos_i.shape, cos_i.device)
    if T.FRESNEL_CONDUCTOR in types_present:
        cond = fr_conductor(torch.abs(cos_i), eta_i, eta_t, k)
        out = v3.where(fr_type == T.FRESNEL_CONDUCTOR, cond, out)
    if T.FRESNEL_DIELECTRIC in types_present:
        diel = fr_dielectric(cos_i, eta_i.x, eta_t.x)
        out = v3.where(fr_type == T.FRESNEL_DIELECTRIC,
                       V3(diel, diel, diel), out)
    return out

"""Fresnel terms of the megakernel (pallas_path.py:3528-3555).

The same formulas as rene_tpu/ops/fresnel.py `fr_dielectric` and
`_fr_conductor_channel`.
"""
from __future__ import annotations

import torch


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

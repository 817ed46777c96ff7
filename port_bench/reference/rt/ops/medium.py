"""Frozen copy of rene_tpu_torch/ops/medium.py at commit ed2dcef.

Homogeneous media of the volpath body (slice K1e), on lane tensors.

Counterpart of rene_tpu/ops/medium.py by name and of the JAX
megakernel's own medium code by content (pallas_path.py:3281-3361):
`med_consts`, `med_tr`, `med_sample`, `med_phase` and `med_sample_p`,
in the kernel's forms, which differ from the XLA ones: the sampled
channel is floor(3 u) of a uniform draw (not a u32 modulo 3), and the
Henyey-Greenstein frame is `onb_from_w`'s. Every lane holds a medium
index as a float (0 is vacuum) into the (K, MED_W) table
scene/pack.py `media_table` packs; an index that names no medium, or a
vacuum row, is vacuum. Directions are unit vectors throughout, so the
reference's `direction.length()` factors are 1.
"""
from __future__ import annotations

import math

import torch

from ..scene import pack as P
from . import rng
from .vec3 import onb_from_w

TWO_PI = 2.0 * math.pi


def med_consts(media: torch.Tensor, med: torch.Tensor):
    """Per lane: (sigma_t rgb, sigma_s rgb, g, vacuum mask)."""
    k = media.shape[0]
    idx = med.long()
    known = (idx >= 0) & (idx < k) & (med == idx.float())
    rows = media[idx.clamp(0, k - 1)]
    vac = ~known | (rows[:, P.MED_VAC] > 0.5)
    rows = torch.where(vac[:, None], 0.0, rows)
    st = tuple(rows[:, P.MED_ST + c] for c in range(3))
    ss = tuple(rows[:, P.MED_SS + c] for c in range(3))
    return st, ss, rows[:, P.MED_G], vac


def med_tr(media, med, t):
    """Transmittance rgb along distance t; 1 in vacuum."""
    st, _, _, vac = med_consts(media, med)
    return tuple(torch.where(vac, 1.0, torch.exp(-st[c] * t))
                 for c in range(3))


def med_sample(media, med, t_max, st_rng):
    """Per-channel distance sampling along a segment of length t_max:
    (sampled, t, weight rgb, advanced streams). Two draws, the channel's
    and the distance's, on every lane."""
    st, ss, _, vac = med_consts(media, med)
    u_ch, st_rng = rng.uniform(st_rng)
    u, st_rng = rng.uniform(st_rng)
    ch_f = torch.floor(u_ch * 3.0)
    sig_ch = torch.where(ch_f == 0.0, st[0],
                         torch.where(ch_f == 1.0, st[1], st[2]))
    dist = -torch.log(torch.clamp_min(1.0 - u, 1e-10)) \
        / torch.clamp_min(sig_ch, 1e-20)
    sampled = dist < t_max
    t = torch.minimum(dist, t_max)
    tr = [torch.exp(-st[c] * t) for c in range(3)]
    dens = [torch.where(sampled, st[c] * tr[c], tr[c]) for c in range(3)]
    pdf = (dens[0] + dens[1] + dens[2]) * (1.0 / 3.0)
    pdf = torch.where(pdf == 0.0, 1.0, pdf)
    w = [torch.where(sampled, tr[c] * ss[c], tr[c]) / pdf for c in range(3)]
    return (sampled & ~vac, torch.where(vac, 0.0, t),
            tuple(torch.where(vac, 1.0, w[c]) for c in range(3)), st_rng)


def med_phase(media, med, cos_theta):
    """Henyey-Greenstein phase value; 0 in vacuum."""
    _, _, g, vac = med_consts(media, med)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    hg = (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-20)), 1e-20)
    return torch.where(vac, 0.0, hg)


def med_sample_p(media, med, wox, woy, woz, st_rng):
    """A Henyey-Greenstein scatter direction about wo (isotropic where
    |g| < 1e-3) and the advanced streams; two draws on every lane."""
    _, _, g, _ = med_consts(media, med)
    u0, st_rng = rng.uniform(st_rng)
    u1, st_rng = rng.uniform(st_rng)
    iso = 1.0 - 2.0 * u0
    sqr = (1.0 - g * g) / torch.clamp_min(1.0 + g - 2.0 * g * u0, 1e-9)
    aniso = -(1.0 + g * g - sqr * sqr) / torch.where(
        torch.abs(g) < 1e-9, 1e-9, 2.0 * g)
    cos_t = torch.where(torch.abs(g) < 1e-3, iso, aniso)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u1
    ux, uy, uz, vx, vy, vz = onb_from_w(wox, woy, woz)
    cp = torch.cos(phi) * sin_t
    sp = torch.sin(phi) * sin_t
    return (ux * cp + vx * sp + wox * cos_t,
            uy * cp + vy * sp + woy * cos_t,
            uz * cp + vz * sp + woz * cos_t, st_rng)

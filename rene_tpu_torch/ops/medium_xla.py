"""The XLA engine's participating media (rene_tpu/ops/medium.py).

Homogeneous media and vacuum over V3 lanes: Beer-Lambert transmittance,
distance sampling in one channel picked by `u32 % 3` with the spectral
MIS pdf, and the Henyey-Greenstein phase function and its sampler, drawing
from the PCG32si stream. ops/medium.py holds the kernels' forms of the
same four functions under the same names, with their own draws: the two
are held to their own references and never mixed.
"""
from __future__ import annotations

import math

import torch

from ..scene import types as T
from . import rng
from . import vec3 as v3
from .gather import at
from .vec3 import V3


def _gather3(table, idx) -> V3:
    g = at(table, idx)
    return V3(g[:, 0], g[:, 1], g[:, 2])


def _sigma_t(buffers, med_idx):
    return (_gather3(buffers["med_sigma_a"], med_idx)
            + _gather3(buffers["med_sigma_s"], med_idx))


def med_is_vacuum(buffers, med_idx):
    return at(buffers["med_type"], med_idx) == T.MEDIUM_VACUUM


def med_tr(buffers, med_idx, direction: V3, t) -> V3:
    """The transmittance along t (medium.rs:106-108); 1 in vacuum."""
    sigma_t = _sigma_t(buffers, med_idx)
    tr = (-sigma_t * (direction.length() * t)).exp()
    return v3.where(med_is_vacuum(buffers, med_idx), 1.0, tr)


def med_sample(buffers, med_idx, org: V3, direction: V3, t_max, state):
    """Distance sampling (medium.rs:110-133): (sampled, position,
    throughput weight, state); a vacuum lane samples nothing and weighs
    1."""
    sigma_t = _sigma_t(buffers, med_idx)
    ch_u, state = rng.next_u32(state)
    channel = ch_u % 3
    u, state = rng.next_f32(state)
    sig_ch = torch.where(channel == 0, sigma_t.x,
                         torch.where(channel == 1, sigma_t.y, sigma_t.z))
    dist = (-torch.log(torch.clamp_min(1.0 - u, 1e-10))
            / torch.clamp_min(sig_ch, 1e-20))
    dlen = direction.length()
    t = dist / torch.clamp_min(dlen, 1e-20)
    sampled = t < t_max
    t = torch.minimum(t, t_max)
    tr = (-sigma_t * (t * dlen)).exp()
    density = v3.where(sampled, sigma_t * tr, tr)
    pdf = density.sum() / 3.0
    pdf = torch.where(pdf == 0.0, 1.0, pdf)
    sigma_s = _gather3(buffers["med_sigma_s"], med_idx)
    weight = v3.where(sampled, tr * sigma_s, tr) * (1.0 / pdf)
    position = org + direction * t

    vac = med_is_vacuum(buffers, med_idx)
    return (sampled & ~vac, v3.where(vac, org, position),
            v3.where(vac, 1.0, weight), state)


def med_phase(buffers, med_idx, wo: V3, wi: V3):
    """The Henyey-Greenstein phase function (medium.rs:135-140); 0 in
    vacuum."""
    g = at(buffers["med_g"], med_idx)
    cos_theta = wo.dot(wi)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    hg = (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-20)), 1e-20)
    return torch.where(med_is_vacuum(buffers, med_idx), 0.0, hg)


def med_sample_p(buffers, med_idx, wo: V3, state):
    """A scattered direction from Henyey-Greenstein (medium.rs:142-157)."""
    g = at(buffers["med_g"], med_idx)
    u0, state = rng.next_f32(state)
    u1, state = rng.next_f32(state)
    iso = 1.0 - 2.0 * u0
    sqr = (1.0 - g * g) / torch.clamp_min(1.0 + g - 2.0 * g * u0, 1e-9)
    aniso = -(1.0 + g * g - sqr * sqr) / torch.where(
        torch.abs(g) < 1e-9, 1e-9, 2.0 * g)
    cos_theta = torch.where(torch.abs(g) < 1e-3, iso, aniso)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * u1
    w1, w2 = v3.coordinate_system(wo)
    d = (w1 * (sin_theta * torch.cos(phi)) + w2 * (sin_theta * torch.sin(phi))
         + wo * cos_theta)
    return d, state

"""Per-pixel agreement of two path-megakernel outputs.

One rule for every comparison of (10, N) lane sums (radiance rgb, first-
hit normal xyz, albedo rgb, rays): the kernel against its plain version
on the card (chip_smoke.py, the `cuda` tests), the CUDA headers compiled
for the CPU against the plain version, and the plain version against the
JAX megakernel in interpret mode. A pixel's radiance agrees when every
channel is within RAD_ATOL + RAD_RTOL * |ref|; its normal and albedo sums
agree when every channel is within AOV_ATOL. Each caller sets the share
of pixels that must agree, by what separates its two sides.
"""
from __future__ import annotations

from typing import Dict

import torch

RAD_RTOL, RAD_ATOL = 1e-3, 1e-5
AOV_ATOL = 1e-4

# Kernel vs plain version on the card. nvcc contracts multiply-adds into
# FMAs and torch's eager kernels do not, so a rare lane takes the other
# side of a branch (a shadow edge, a Russian-roulette draw, a refraction)
# and then follows another path; every other lane agrees to float
# rounding. Sound runs read radiance 100% and AOV 99.76% (materials 128x64
# x 4 spp) and image means equal to 1e-6; a planted fault in one material
# moves the radiance share and the mean past these limits (PERF.md).
CARD_FRAC = 0.995
CARD_MEAN_REL = 1e-3


def agreement(out, ref) -> Dict[str, float]:
    """Shares of pixels that agree, the largest and mean absolute
    differences, both image means and both ray totals of two (10, N)
    arrays (torch tensors or numpy arrays; rows 0-8 are compared)."""
    out = torch.as_tensor(out)
    ref = torch.as_tensor(ref)
    d = (out[0:9] - ref[0:9]).abs()
    rad_ok = (d[0:3] <= RAD_ATOL + RAD_RTOL * ref[0:3].abs()).all(0)
    aov_ok = (d[3:9] <= AOV_ATOL).all(0)
    mean_o = out[0:3].double().mean().item()
    mean_r = ref[0:3].double().mean().item()
    return {"rad_frac": rad_ok.double().mean().item(),
            "aov_frac": aov_ok.double().mean().item(),
            "max_abs": d.max().item(), "mean_abs": d.double().mean().item(),
            "mean_out": mean_o, "mean_ref": mean_r,
            "mean_rel": abs(mean_o - mean_r) / max(abs(mean_r), 1e-12),
            "rays_out": out[9].double().sum().item() if out.shape[0] > 9
            else None,
            "rays_ref": ref[9].double().sum().item() if ref.shape[0] > 9
            else None}


def check_card(a: Dict[str, float], what: str) -> None:
    """Raise unless `a` (from `agreement`) meets the card's limits."""
    if a["rad_frac"] < CARD_FRAC or a["aov_frac"] < CARD_FRAC \
            or a["mean_rel"] > CARD_MEAN_REL:
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version: radiance "
            f"{a['rad_frac']:.4f}, AOV {a['aov_frac']:.4f} (need "
            f"{CARD_FRAC}), image mean {a['mean_rel']:.2e} (need "
            f"<= {CARD_MEAN_REL})")

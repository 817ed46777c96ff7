"""The megakernel's per-lane xorshift32 stream.

Counterpart of rene_tpu/integrators/pallas_path.py `uniform` (:1680-1688)
in its interpret-mode form, seeded as at :4300-4327. On the TPU the
kernel drew from the hardware generator, which no other device can
reproduce; the port adopts the interpret-mode stream on every device,
so a lane's draws are the same in the JAX interpret run, the plain
version here and the CUDA kernel.

torch's CPU uint32 has no add or shifts, so the 32-bit math runs on
int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
TILE_LANES = 8192   # TILE_SUB * 128 lanes per TPU grid step (:76-77)


def seed_state(pix: torch.Tensor, seed: int) -> torch.Tensor:
    """Initial state of each lane: (pix * 2654435761 ^ (seed + tile *
    65537)) | 1, with tile = pix // 8192 the TPU grid step the pixel fell
    in. `pix` = px + py * W; returns int64 holding uint32 values."""
    pix = pix.to(torch.int64)
    seed_u = (int(seed) + (pix // TILE_LANES) * 65537) & MASK
    return (((pix * 2654435761) & MASK) ^ seed_u) | 1


def uniform(st: torch.Tensor):
    """(u in [0, 1), next state): xorshift32 then the mantissa bitcast."""
    st = st ^ ((st << 13) & MASK)
    st = st ^ (st >> 17)
    st = st ^ ((st << 5) & MASK)
    bits = ((st >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0, st

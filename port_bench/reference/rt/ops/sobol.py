"""Frozen copy of rene_tpu_torch/ops/sobol.py at commit ed2dcef, without
its probe.

Padded 2D Sobol sampler with hash-based Owen scrambling.

Counterpart of rene_tpu/ops/sobol.py (`reverse32` :45, `hash_u32` :58,
`_laine_karras` :67, `owen_scramble` :78, `sobol2_16` :83, `ld2_bits`
:92) and of the megakernel's Sobol helpers (`ld2`, `sob_pixkey` and the
draw slots, rene_tpu/integrators/pallas_path.py:1697-1720). Per sampling
decision (camera jitter, one bounce's BSDF pair, its light-sampling
pairs, ...) every pixel draws the same base (0,2)-sequence point, with a
per-(pixel, decision, chunk) hash-based Owen scramble and an Owen shuffle
of the sample index (Burley, "Practical Hash-based Owen Scrambling",
JCGT 2020).

torch's CPU uint32 has no add or shifts, so the 32-bit math runs on int64
tensors (or python ints) holding uint32 values, masked to 32 bits, with
the products through rng._mul32. csrc/sobol.cuh is the same math per
lane for the CUDA kernels.
"""
from __future__ import annotations

import torch

from .rng import MASK, _mul32


def _sobol2_dirs():
    """32 direction numbers of Sobol dimension 2 (poly x+1) as 32-bit
    binary fractions, MSB-aligned."""
    m = [1]
    for i in range(1, 32):
        m.append((m[-1] ^ (m[-1] << 1)) & ((1 << (i + 1)) - 1))
    return [m[i] << (31 - i) for i in range(32)]


SOBOL2_DIRS = _sobol2_dirs()
INDEX_BITS = 16     # sample indices are masked to 16 bits

# the draw slots of a bounce (pallas_path.py:1700-1701)
(SLOT_CAM, SLOT_BSDF, SLOT_COIN, SLOT_NEE1, SLOT_NEE2, SLOT_RR,
 SLOT_MISC, SLOT_MED) = range(8)


def reverse32(x):
    """Bitwise reversal of uint32 (5-step shift-mask ladder)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK) | (x >> 16)


def hash_u32(x):
    """Finalizer-style uint32 hash (xxhash/murmur avalanche constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def laine_karras(x, seed):
    """Laine-Karras style hash: scrambles the low bits of x with a
    per-`seed` permutation that is Owen-uniform after reversal."""
    x = (x + seed) & MASK
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(v, seed):
    """Nested uniform (Owen) scramble of a 32-bit fraction v."""
    return reverse32(laine_karras(reverse32(v), seed))


def sobol2_16(idx):
    """Dimension-2 Sobol value of `idx` (< 2^16) as a 32-bit fraction."""
    y = idx * 0
    for b in range(INDEX_BITS):
        y = y ^ (((idx >> b) & 1) * SOBOL2_DIRS[b])
    return y


def ld2_bits(idx, key):
    """Owen-scrambled (0,2)-sequence point as a pair of uint32
    fractions. `idx`: the sample number (< 2^16); `key`: hash input
    mixing (pixel, decision, chunk seed). The index takes a per-key Owen
    shuffle first (rev-LK-rev), so that two decisions' point sets are
    paired anew."""
    sidx = reverse32(laine_karras(reverse32(idx),
                                  hash_u32(key ^ 0x9E3779B9))) \
        & ((1 << INDEX_BITS) - 1)
    u = owen_scramble(reverse32(sidx), hash_u32(key))
    v = owen_scramble(sobol2_16(sidx), hash_u32(key ^ 0x6A09E667))
    return u, v


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> [0, 1) float32 through the mantissa bitcast."""
    m = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return m.view(torch.float32) - 1.0


def ld2(idx, keyv, depth, slot: int):
    """The megakernel's draw pair (`ld2` :1708): the Owen-scrambled
    (0,2) point for sample index `idx` at decision (`depth`, `slot`) of
    the pixel keyed by `keyv`, as two float32 tensors in [0, 1). `idx`
    and `depth` are integer tensors (or ints), `keyv` int64 holding
    uint32 values."""
    key = keyv ^ _mul32(depth & MASK, 0x9E3779B9) \
        ^ ((slot * 0x632BE59B) & MASK)
    ub, vb = ld2_bits(idx & 0xFFFF, key)
    return bits_to_unit(ub), bits_to_unit(vb)


def pixkey(pid, seed_u, slot=0):
    """A pixel's scrambling key (`sob_pixkey` :1718): hash_u32(pid ^
    seed_u * 0x85EBCA6B), with `pid` = px + py * W computed in integers
    (the reference computes it in float32, exact below 2^24 pixels) and
    `seed_u` the chunk's (megakernel: per grid step) or the wave's seed.
    A packed megakernel lane mixes its sample slot into the seed, seed_u ^
    slot * 0x9E3779B1 (:4333-4337), so that each slot draws its own
    scrambled sequence."""
    seed_u = (seed_u & MASK) ^ _mul32(slot, 0x9E3779B1)
    return hash_u32((pid & MASK) ^ _mul32(seed_u, 0x85EBCA6B))

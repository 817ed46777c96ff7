"""Frozen copy of rene_tpu_torch/ops/rng.py at commit ed2dcef; seed_state
takes a seed per lane, and the wave's lane streams are left out.

The megakernel's per-lane xorshift32 stream.

Counterpart of rene_tpu/integrators/pallas_path.py `uniform` (:1680-1688)
in its interpret-mode form, seeded as at :4300-4327 with the tile
layouts of `make_pallas_batch_fn` (:5892-5947). On the TPU the
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
BLOCK = 32          # cluster mode: one grid step per 32x32 pixel block
PACKS = (1, 4, 16, 64, 256)   # sample slots per pixel a tile may pack


def block_edge(pack):
    """The pixel block edge of a cluster-mode tile that packs `pack`
    sample slots per pixel into its 1024 lanes: 32 // sqrt(pack)
    (`make_pallas_batch_fn` :5904). `pack` is an int, or an int64 tensor
    of each lane's pack."""
    packs = pack.unique().tolist() if torch.is_tensor(pack) else [pack]
    for p in packs:
        if p not in PACKS:
            raise ValueError(f"pack must be one of {PACKS}, got {p}")
    if torch.is_tensor(pack):
        return BLOCK // pack.double().sqrt().round().long()
    return BLOCK >> (pack.bit_length() - 1) // 2


def tile_of(pix: torch.Tensor, width: int, blocks: bool,
            bs: int = BLOCK) -> torch.Tensor:
    """The TPU grid step that pixel `pix` = px + py * width fell in: the
    8192-lane step of its pixel index, or in cluster mode (`blocks`: a
    scene with a world mesh or shared-BLAS instances) its bs x bs block
    (`block_edge`), blocks numbered row by row over ceil(width / bs)
    columns."""
    pix = pix.to(torch.int64)
    if not blocks:
        return pix // TILE_LANES
    bw = -(-width // bs)
    return (pix // width // bs) * bw + (pix % width) // bs


def seed_state(lane: torch.Tensor, seed: int, tile=None) -> torch.Tensor:
    """Initial state of each lane: (lane * 2654435761 ^ (seed + tile *
    65537)) | 1, with `tile` its grid step (`tile_of`; by default the
    8192-lane step). `lane` = pix + slot * npix is the id of sample slot
    `slot` of pixel pix = px + py * W (the pixel itself where a lane owns
    one pixel, :4307-4321); returns int64 holding uint32 values."""
    lane = lane.to(torch.int64)
    if tile is None:
        tile = lane // TILE_LANES
    seed_u = (seed + tile * 65537) & MASK
    return (((lane * 2654435761) & MASK) ^ seed_u) | 1


def _mul32(h, c: int):
    """h * c mod 2^32 for int64 tensors (or ints) holding uint32 values,
    without an int64 overflow: c is split in 16-bit halves."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & MASK


def fmix32(h):
    """MurmurHash3's 32-bit finalizer: a bijection whose output bits each
    depend on every input bit, nonlinearly."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform(st: torch.Tensor):
    """(u in [0, 1), next state): xorshift32 then the mantissa bitcast."""
    st = st ^ ((st << 13) & MASK)
    st = st ^ (st >> 17)
    st = st ^ ((st << 5) & MASK)
    bits = ((st >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0, st


# -- PCG32si, the XLA engine's per-pixel stream (rene_tpu/ops/rng.py) ------
# 32-bit state, RXS-M-XS output; every draw returns (value, new state).
# States are int64 tensors holding uint32 values: every product below is
# under 2^62, so int64 holds it before the mask.

_PCG_MULT = 747796405
_PCG_INC = 2891336453
_PCG_OUT_MULT = 277803737


def _pcg_step(state):
    return (state * _PCG_MULT + _PCG_INC) & MASK


def _pcg_output(state):
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * _PCG_OUT_MULT) & MASK
    return (word >> 22) ^ word


def pcg_init(seed):
    """PCG32si::new: step, add the seed, step. `seed` is an int64 tensor
    (or an int) of uint32 values."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & MASK
    state = _pcg_step(seed)
    return _pcg_step((state + seed) & MASK)


def next_u32(state):
    return _pcg_output(state), _pcg_step(state)


def next_f32(state):
    """A 24-bit-mantissa uniform in [0, 1)."""
    u, state = next_u32(state)
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24)), state


def next_f32_range(state, lo, hi):
    u, state = next_f32(state)
    return lo + (hi - lo) * u, state

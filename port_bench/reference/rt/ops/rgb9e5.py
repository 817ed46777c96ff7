"""Frozen copy of rene_tpu_torch/ops/rgb9e5.py at commit ed2dcef.

Shared-exponent RGB9E5 packing for the kernel image atlas.

The megakernel's paged VMEM fetch emulates a 2D gather with
8 lane-gathers + selects per page PER CHANNEL (pallas_path.fetch_image)
— and the r5a ablation partition showed texture-heavy scenes are ~92%
fetch-bound. Packing a texel's three channels into ONE u32 (9-bit
mantissas, 5-bit shared exponent — the standard HDR texture format the
reference gets from Vulkan for free) cuts the per-page gather/select
work 3x; the decode happens once per fetched corner after the sweep.

Both engines must see identical texel values for the interpret parity
suites to stay exact, so `quantize` (encode∘decode roundtrip) is
applied ONCE at device-scene build (scene/device.py) — the XLA engine
consumes the quantized floats directly, the kernel re-encodes them
losslessly (values are exactly m·2^(e-24), so encode∘decode∘encode is
bit-stable) and decodes in-kernel via exact mantissa bitcasts.

Range: [0, 65408]; negatives/NaN clamp to 0, +inf to max. Worst-case
relative error 2^-9 ≈ 0.2% — below the 8-bit LDR quantization most
pbrt textures were born with.
"""
import numpy as np

BIAS = 15
MBITS = 9
MMAX = (1 << MBITS) - 1          # 511
MAX_E = 31
MAXVAL = (MMAX / 512.0) * 2.0 ** (MAX_E - BIAS)   # 65408.0


def encode(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float -> (...,) uint32 RGB9E5."""
    c = np.nan_to_num(np.asarray(rgb, np.float32), nan=0.0,
                      posinf=MAXVAL, neginf=0.0)
    c = np.clip(c, 0.0, MAXVAL).astype(np.float64)
    maxc = c.max(axis=-1)
    e = np.zeros(maxc.shape, np.int32)
    nz = maxc > 0
    with np.errstate(divide="ignore"):
        e[nz] = np.clip(np.floor(np.log2(maxc[nz])).astype(np.int64)
                        + BIAS + 1, 0, MAX_E).astype(np.int32)
    scale = np.exp2((e - BIAS - MBITS).astype(np.float64))
    m = np.rint(c / scale[..., None])
    # round-up overflow past 511 -> bump the shared exponent
    over = m.max(axis=-1) > MMAX
    e = np.where(over & (e < MAX_E), e + 1, e).astype(np.int32)
    scale = np.exp2((e - BIAS - MBITS).astype(np.float64))
    m = np.clip(np.rint(c / scale[..., None]), 0, MMAX).astype(np.uint32)
    return (m[..., 0] | (m[..., 1] << np.uint32(MBITS))
            | (m[..., 2] << np.uint32(2 * MBITS))
            | (e.astype(np.uint32) << np.uint32(3 * MBITS)))


def decode(p: np.ndarray) -> np.ndarray:
    """(...,) uint32 -> (..., 3) float32 (exact: m·2^(e-24))."""
    p = np.asarray(p, np.uint32)
    r = (p & MMAX).astype(np.float32)
    g = ((p >> np.uint32(MBITS)) & MMAX).astype(np.float32)
    b = ((p >> np.uint32(2 * MBITS)) & MMAX).astype(np.float32)
    e = ((p >> np.uint32(3 * MBITS)) & np.uint32(31)).astype(np.int32)
    s = np.exp2((e - BIAS - MBITS).astype(np.float32))
    return np.stack([r * s, g * s, b * s], axis=-1)


def quantize(rgb: np.ndarray) -> np.ndarray:
    """Round-trip (..., 3) floats onto the RGB9E5 grid."""
    return decode(encode(rgb))

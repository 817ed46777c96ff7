"""SSIM (structural similarity) in numpy, for golden-image comparison.

A copy of rene_tpu/utils/ssim.py: an 11-tap Gaussian (sigma 1.5),
separable with reflect padding, the mean over channels.
"""
from __future__ import annotations

import numpy as np


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return k


def _filter2(img, k):
    """Separable 2D convolution with reflect padding (per channel)."""
    pad = len(k) // 2
    out = np.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"),
                              0, out)
    out = np.pad(out, ((0, 0), (pad, pad)), mode="reflect")
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"),
                              1, out)
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels; a, b: (H,W) or (H,W,C) in [0, data_range]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[2]):
        x = a[..., ch]
        y = b[..., ch]
        mx = _filter2(x, k)
        my = _filter2(y, k)
        mx2 = mx * mx
        my2 = my * my
        mxy = mx * my
        sx = _filter2(x * x, k) - mx2
        sy = _filter2(y * y, k) - my2
        sxy = _filter2(x * y, k) - mxy
        m = ((2 * mxy + c1) * (2 * sxy + c2)) / (
            (mx2 + my2 + c1) * (sx + sy + c2))
        vals.append(m.mean())
    return float(np.mean(vals))

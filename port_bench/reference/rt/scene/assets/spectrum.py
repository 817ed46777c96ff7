"""Frozen copy of rene_tpu_torch/scene/assets/spectrum.py at commit ed2dcef.

Spectral data: CIE 1931 color matching, SPD files, blackbody emitters.

The reference ships 471-sample CIE X/Y/Z tables
(rene/src/scene/spectrum.rs:5-1467) and converts sampled
spectra to RGB via the pbrt XYZ->sRGB matrix (spectrum.rs:1487-1506).
Instead of shipping tables, we evaluate the multi-lobe Gaussian analytic fit
of the CIE 1931 CMFs (Wyman, Sloan & Shirley, JCGT 2013) on the same
360..830nm 1nm grid; accuracy is well within the tolerance of RGB rendering.

`temperature_to_rgb` replaces the reference's `blackbody` crate
(intermediate_scene.rs:272-279): Planck's law normalized to peak emission 1
(Wien displacement), integrated against the CMFs, converted to linear sRGB.
"""
from __future__ import annotations

import numpy as np

N_CIE_SAMPLES = 471
CIE_LAMBDA = np.arange(360.0, 360.0 + N_CIE_SAMPLES, dtype=np.float64)


def _g(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_fit(lam: np.ndarray):
    """Analytic CIE 1931 CMF fit (Wyman et al. 2013, multi-lobe)."""
    lam = np.asarray(lam, dtype=np.float64)
    x = (1.056 * _g(lam, 599.8, 37.9, 31.0)
         + 0.362 * _g(lam, 442.0, 16.0, 26.7)
         - 0.065 * _g(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _g(lam, 568.8, 46.9, 40.5)
         + 0.286 * _g(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _g(lam, 437.0, 11.8, 36.0)
         + 0.681 * _g(lam, 459.0, 26.0, 13.8))
    return x, y, z


CIE_X, CIE_Y, CIE_Z = cie_xyz_fit(CIE_LAMBDA)
CIE_Y_INTEGRAL = float(np.sum(CIE_Y))  # ~106.9 on the 1nm grid


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    """pbrt XYZToRGB matrix (reference spectrum.rs:1500-1505)."""
    m = np.array([[3.240479, -1.537150, -0.498535],
                  [-0.969256, 1.875991, 0.041556],
                  [0.055648, -0.204043, 1.057311]], dtype=np.float64)
    return (m @ np.asarray(xyz, dtype=np.float64)).astype(np.float32)


def spd_samples_to_rgb(lambdas, values) -> np.ndarray:
    """Piecewise-linear SPD -> RGB (reference from_sampled, spectrum.rs:1487)."""
    order = np.argsort(np.asarray(lambdas, dtype=np.float64))
    lam = np.asarray(lambdas, dtype=np.float64)[order]
    val = np.asarray(values, dtype=np.float64)[order]
    samp = np.interp(CIE_LAMBDA, lam, val, left=val[0], right=val[-1])
    scale = (CIE_LAMBDA[-1] - CIE_LAMBDA[0]) / (CIE_Y_INTEGRAL * N_CIE_SAMPLES)
    xyz = np.array([np.sum(samp * CIE_X), np.sum(samp * CIE_Y),
                    np.sum(samp * CIE_Z)]) * scale
    return xyz_to_rgb(xyz)


def load_spd(path: str) -> np.ndarray:
    """Parse a `.spd` file of "<lambda> <value>" lines -> RGB."""
    lambdas, values = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            lambdas.append(float(parts[0]))
            values.append(float(parts[1]))
    if not lambdas:
        raise ValueError(f"empty SPD file {path}")
    return spd_samples_to_rgb(lambdas, values)


def temperature_to_rgb(temperature_k: float) -> np.ndarray:
    """Normalized blackbody color at temperature T (pbrt BlackbodyNormalized).

    Planck spectral radiance scaled so the Wien-peak wavelength has emission
    1, integrated against the CMFs, then XYZ->RGB; negatives clamped.
    """
    t = max(float(temperature_k), 1.0)
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = CIE_LAMBDA * 1e-9

    def planck(l):
        return (2 * h * c * c) / (l ** 5 * np.expm1(h * c / (l * kb * t)))

    lam_peak = 2.8977721e-3 / t
    le = planck(lam) / planck(np.array([lam_peak]))[0]
    scale = (CIE_LAMBDA[-1] - CIE_LAMBDA[0]) / (CIE_Y_INTEGRAL * N_CIE_SAMPLES)
    xyz = np.array([np.sum(le * CIE_X), np.sum(le * CIE_Y),
                    np.sum(le * CIE_Z)]) * scale
    return np.maximum(xyz_to_rgb(xyz), 0.0)

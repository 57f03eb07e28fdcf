"""Load-time spectrum conversion to linear sRGB.

Port of the numpy half of ``mitsuba_nlvrl_tpu/core/spectrum.py``: the
port renders in RGB (the reference's ``scalar_rgb`` variant), so tabulated
spectra ("400:0.3, 500:0.8, ...") and blackbodies are integrated to linear
sRGB when a scene is loaded:

  * ``spectrum_to_rgb`` — Riemann integration of the lerped spectrum
    against the CIE 1931 curves, then XYZ -> sRGB;
  * spectra are pre-scaled by 1/106.75 (``CIE_Y_NORMALIZATION``) so a
    unit-valued spectrum has luminance 1.

The render-time colour operations (``srgb_to_xyz``, ``xyz_to_srgb``,
``luminance``) act on torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .cie_data import (CIE_MIN, CIE_MAX, CIE_SAMPLES, CIE_Y_NORMALIZATION,
                       CIE_X, CIE_Y, CIE_Z)

__all__ = ['CIE_Y_NORMALIZATION', 'XYZ_TO_SRGB', 'SRGB_TO_XYZ',
           'cie1931_xyz_np', 'spectrum_to_rgb', 'blackbody_rgb',
           'srgb_to_xyz', 'xyz_to_srgb', 'luminance']

_CIE_XYZ_NP = np.stack([np.asarray(CIE_X), np.asarray(CIE_Y),
                        np.asarray(CIE_Z)])

# ITU-R Rec. BT.709 matrices
XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                        [-0.969256, 1.875991, 0.041556],
                        [0.055648, -0.204043, 1.057311]])
SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]])


def cie1931_xyz_np(wavelength: np.ndarray) -> np.ndarray:
    """Lerp the 5nm CIE table; returns (..., 3). Zero outside [360, 830]."""
    wavelength = np.asarray(wavelength, np.float64)
    t = (wavelength - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    active = (wavelength >= CIE_MIN) & (wavelength <= CIE_MAX)
    i0 = np.clip(t.astype(np.int64), 0, CIE_SAMPLES - 2)
    w1 = t - i0
    v = _CIE_XYZ_NP[:, i0] * (1 - w1) + _CIE_XYZ_NP[:, i0 + 1] * w1
    return np.where(active, v, 0.0).T


def spectrum_to_rgb(wavelengths, values, bounded: bool = True,
                    unit_scale: bool = True) -> np.ndarray:
    """Convert a linearly-interpolated tabulated spectrum to linear sRGB.

    ``unit_scale`` applies the 1/106.75 CIE-Y normalization applied to
    all spectra in RGB mode. ``bounded`` clamps reflectances to [0, 1]
    (unbounded quantities like radiance only clamp negatives).
    """
    wavelengths = np.asarray(wavelengths, np.float64)
    values = np.asarray(values, np.float64)
    if unit_scale:
        values = values * CIE_Y_NORMALIZATION
    steps = 1000
    x = CIE_MIN + np.arange(steps) / (steps - 1) * (CIE_MAX - CIE_MIN)
    inside = (x >= wavelengths[0]) & (x <= wavelengths[-1])
    y = np.interp(x, wavelengths, values)
    xyz_curves = cie1931_xyz_np(x)            # (steps, 3)
    xyz = (xyz_curves * np.where(inside, y, 0.0)[:, None]).sum(0)
    xyz *= (CIE_MAX - CIE_MIN) / steps
    rgb = XYZ_TO_SRGB @ xyz
    if bounded:
        rgb = np.clip(rgb, 0.0, 1.0)
    else:
        rgb = np.maximum(rgb, 0.0)
    return rgb.astype(np.float32)


def blackbody_rgb(temperature: float) -> np.ndarray:
    """Planck's law radiance (W/m^2/sr/nm) integrated to RGB."""
    lam = np.arange(CIE_MIN, CIE_MAX + 1e-3, 5.0) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    P = (2 * h * c * c) / lam**5 \
        / (np.exp(h * c / (lam * kb * temperature)) - 1) * 1e-9
    return spectrum_to_rgb(lam * 1e9, P, bounded=False, unit_scale=True)


# --- render-time colour operations --------------------------------------------

def srgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return rgb @ torch.as_tensor(SRGB_TO_XYZ, dtype=torch.float32,
                                 device=rgb.device).T


def xyz_to_srgb(xyz: torch.Tensor) -> torch.Tensor:
    return xyz @ torch.as_tensor(XYZ_TO_SRGB, dtype=torch.float32,
                                 device=xyz.device).T


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160
            + rgb[..., 2] * 0.072169)

"""Constants of the spectral variant that the RGB emitter packing reads.

Port of the wavelength grid and the normalised D65 illuminant
(``D65_HAT``) of ``mitsuba_nlvrl_tpu/core/spectral.py``. The hero-wavelength
transport itself is ROADMAP item 10.
"""
from __future__ import annotations

import numpy as np

from .cie_data import CIE_MIN, CIE_MAX, CIE_SAMPLES, CIE_Y

__all__ = ['CIE_MIN', 'CIE_MAX', 'CIE_SAMPLES', 'WAVELENGTH_MIN',
           'WAVELENGTH_MAX', 'D65_DATA', 'D65_HAT']

WAVELENGTH_MIN = 360.0
WAVELENGTH_MAX = 830.0

# CIE Standard Illuminant D65 relative SPD, 360-830 nm at 5 nm, normalized
# to 100 at 560 nm (standard public CIE data)
D65_DATA = np.array([
    46.6383, 49.3637, 52.0891, 51.0323, 49.9755, 52.3118, 54.6482, 68.7015,
    82.7549, 87.1204, 91.486, 92.4589, 93.4318, 90.057, 86.6823, 95.7736,
    104.865, 110.936, 117.008, 117.41, 117.812, 116.336, 114.861, 115.392,
    115.923, 112.367, 108.811, 109.082, 109.354, 108.578, 107.802, 106.296,
    104.79, 106.239, 107.689, 106.047, 104.405, 104.225, 104.046, 102.023,
    100.0, 98.1671, 96.3342, 96.0611, 95.788, 92.2368, 88.6856, 89.3459,
    90.0062, 89.8026, 89.5991, 88.6489, 87.6987, 85.4936, 83.2886, 83.4939,
    83.6992, 81.863, 80.0268, 80.1207, 80.2146, 81.2462, 82.2778, 80.281,
    78.2842, 74.0027, 69.7213, 70.6652, 71.6091, 72.979, 74.349, 67.9765,
    61.604, 65.7448, 69.8856, 72.4863, 75.087, 69.3398, 63.5927, 55.0054,
    46.4182, 56.6118, 66.8054, 65.0941, 63.3828, 63.8434, 64.304, 61.8779,
    59.4519, 55.7054, 51.959, 54.6998, 57.4406, 58.8765, 60.3125,
], np.float64)

_DLAM = (CIE_MAX - CIE_MIN) / (CIE_SAMPLES - 1)

# D65 normalised so that integrating it against the CIE curves gives the
# sRGB whitepoint with Y = 1
_D65_Y = float((D65_DATA * np.asarray(CIE_Y)).sum() * _DLAM)
D65_HAT = (D65_DATA / _D65_Y).astype(np.float64)          # (95,)

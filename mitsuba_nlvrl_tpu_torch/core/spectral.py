"""Spectral rendering support: hero-wavelength sampling, CIE integration
and sRGB-to-spectrum upsampling.

Port of ``mitsuba_nlvrl_tpu/core/spectral.py``:

  * ``sample_hero_wavelengths`` / ``pdf_rgb_spectrum``: the continuous
    importance distribution over [360, 830] nm of an RGB camera, drawn as
    4 stratified hero wavelengths a lane;
  * ``cie1931_xyz``: a lerp of the 5 nm CIE tables;
  * sRGB-to-spectrum upsampling with the sigmoid-polynomial reflectance
    model, reflectance(lambda) = sigmoid(c0 t^2 + c1 t + c2), its
    coefficients fitted by damped Gauss-Newton over an (argmax channel,
    sqrt(max), a, b) grid (``build_lut``) and trilerped at render time;
  * the D65 illuminant, normalised so that an RGB (1, 1, 1) emitter
    integrates back to sRGB (1, 1, 1) through the spectral film path.

The coefficient table is the port's own copy, ``data/srgb_coeff.npz``;
where it is missing, ``build_lut`` fits it (about half a minute) and
writes it to ``_build/``.

The estimator develops a path contribution L(lambda_j) with the sampled
inverse pdfs w_j to ``srgb = XYZ_TO_SRGB @ mean_j(L_j * cie_xyz(lambda_j)
* w_j)``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import math as m
from .cie_data import CIE_MIN, CIE_MAX, CIE_SAMPLES, CIE_X, CIE_Y, CIE_Z
from .spectrum import SRGB_TO_XYZ, XYZ_TO_SRGB

WAVELENGTH_MIN = 360.0
WAVELENGTH_MAX = 830.0
N_HERO = 4          # wavelengths carried a lane

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

_LAM = np.linspace(CIE_MIN, CIE_MAX, CIE_SAMPLES)
_CMF = np.stack([CIE_X, CIE_Y, CIE_Z], axis=-1)          # (95, 3)
_DLAM = (CIE_MAX - CIE_MIN) / (CIE_SAMPLES - 1)

# D65 normalised so that integrating it against the CIE curves gives the
# sRGB whitepoint with Y = 1
_D65_Y = float((D65_DATA * _CMF[:, 1]).sum() * _DLAM)
D65_HAT = (D65_DATA / _D65_Y).astype(np.float64)          # (95,)

# CIE-and-D65 weighted quadrature of the upsampling fit: a model spectrum
# s(lambda) maps to XYZ as s @ _FIT_W
_FIT_W = (_CMF * D65_HAT[:, None] * _DLAM)                # (95, 3)
_T_GRID = (_LAM - WAVELENGTH_MIN) / (WAVELENGTH_MAX - WAVELENGTH_MIN)
_BASIS = np.stack([_T_GRID ** 2, _T_GRID, np.ones_like(_T_GRID)])  # (3, 95)

_CMF_F32 = _CMF.astype(np.float32)
_D65_F32 = D65_HAT.astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


# --- hero wavelength sampling ------------------------------------------------

def sample_hero_wavelengths(u):
    """N_HERO stratified wavelengths a lane from the RGB-camera importance
    distribution; u: (N,) uniform. Returns (wavelengths (N, 4), inverse
    pdfs (N, 4))."""
    u = u.to(torch.float32)
    shift = torch.arange(N_HERO, dtype=torch.float32,
                         device=u.device) / N_HERO
    us = torch.remainder(u[:, None] + shift[None, :], 1.0)
    # the products and sums fused as the compiled reference fuses them
    lam = m.fma(torch.atanh(m.fma(us, -1.8275019724092267,
                                  torch.full_like(us, 0.8569106254698279))),
                -138.88888888888889, torch.full_like(us, 538.0))
    tmp = torch.cosh(0.0072 * (lam - 538.0))
    weight = 253.82 * tmp * tmp                           # = 1 / pdf
    return lam, weight


def pdf_rgb_spectrum(lam):
    """The per-wavelength pdf of ``sample_hero_wavelengths``."""
    lam = lam.to(torch.float32)
    tmp = 1.0 / torch.cosh(0.0072 * (lam - 538.0))
    ok = (lam >= WAVELENGTH_MIN) & (lam <= WAVELENGTH_MAX)
    return torch.where(ok, 0.003939804229326285 * tmp * tmp, 0.0)


def _table_lerp(tab, lam):
    """Lerp a table on the CIE grid at lam; zero outside [360, 830]."""
    t = (lam - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    ok = (lam >= CIE_MIN) & (lam <= CIE_MAX)
    i0 = t.to(torch.int32).clamp(0, CIE_SAMPLES - 2).long()
    w1 = t - i0
    return tab[i0], tab[i0 + 1], w1, ok


def cie1931_xyz(lam):
    """The CIE curves lerped at wavelengths lam (...,): (..., 3)."""
    v0, v1, w1, ok = _table_lerp(_const(_CMF_F32, lam), lam)
    w1 = w1[..., None]
    v = v0 * (1.0 - w1) + v1 * w1
    return torch.where(ok[..., None], v, 0.0)


def spectral_to_srgb(values, lam, inv_pdf):
    """Develop a lane's spectral radiance samples to linear sRGB.
    values, lam, inv_pdf: (N, 4). Returns (N, 3)."""
    xyz = ((values * inv_pdf)[..., None] * cie1931_xyz(lam)).mean(dim=-2)
    return xyz @ torch.as_tensor(XYZ_TO_SRGB, dtype=torch.float32,
                                 device=lam.device).T


# --- sigmoid-polynomial model ------------------------------------------------

def _sigmoid_np(v):
    return np.clip(0.5 * v / np.sqrt(v * v + 1.0) + 0.5, 0.0, 1.0)


def fit_sigmoid_coeffs(rgb, iters: int = 40):
    """Damped Gauss-Newton fit of sigmoid-polynomial coefficients whose
    model spectrum integrates (under D65 and the CIE curves) back to the
    linear sRGB values in [0, 1]. rgb: (M, 3) -> coefficients (M, 3);
    numpy on the host (table time only)."""
    rgb = np.clip(np.asarray(rgb, np.float64), 1e-4, 1.0 - 1e-4)
    target = rgb @ SRGB_TO_XYZ.T                          # (M, 3)
    M = rgb.shape[0]
    c = np.zeros((M, 3))
    c[:, 2] = np.arctanh(2.0 * rgb.mean(-1) - 1.0)        # flat start
    lam_damp = np.full((M,), 1e-6)
    prev = np.full((M,), np.inf)
    for _ in range(iters):
        v = c @ _BASIS                                    # (M, 95)
        s = _sigmoid_np(v)
        r = s @ _FIT_W - target                           # (M, 3) residual
        err = (r * r).sum(-1)
        # adaptive damping: grow where the error increased
        lam_damp = np.where(err > prev, lam_damp * 10.0, lam_damp * 0.5)
        lam_damp = np.clip(lam_damp, 1e-9, 1e3)
        prev = np.minimum(prev, err)
        ds = 0.5 / np.power(v * v + 1.0, 1.5)             # (M, 95)
        # J[m, out, j] = sum_k ds[m,k] * basis[j,k] * W[k,out]
        J = np.einsum('mk,jk,ko->moj', ds, _BASIS, _FIT_W)
        A = J.transpose(0, 2, 1) @ J
        A += lam_damp[:, None, None] * np.eye(3)
        g = np.einsum('moj,mo->mj', J, r)
        dc = np.linalg.solve(A, g[..., None])[..., 0]
        c = c - np.clip(dc, -100.0, 100.0)
    return c


# --- coefficient table -------------------------------------------------------

LUT_A = 33       # off-max channel resolution
LUT_S = 32       # sqrt(max-component) resolution
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT_PATH = os.path.join(_PKG, 'data', 'srgb_coeff.npz')
BUILT_LUT_PATH = os.path.join(_PKG, '_build', 'srgb_coeff.npz')
_LUT_CACHE = None
_LUT_DEVICE = {}

# the model's wavelength span; the table's sqrt(max) origin and the
# scale to its grid, (LUT_S - 1) / (1 - s0), folded into one float32
# factor as the compiled reference folds it
_SPAN_RCP = m.rcp32(WAVELENGTH_MAX - WAVELENGTH_MIN)
_S0 = float(np.sqrt(np.float32(1e-4)))
_S_SCALE = float(np.float32(m.rcp32(np.float32(1.0) - np.float32(_S0)))
                 * np.float32(LUT_S - 1))


def build_lut():
    """Fit the (3, LUT_S, LUT_A, LUT_A, 3) coefficient table: the argmax
    channel, then sqrt(max) and the two other components relative to the
    max."""
    a = np.linspace(0.0, 1.0, LUT_A)
    s = np.linspace(np.sqrt(1e-4), 1.0, LUT_S)
    out = np.zeros((3, LUT_S, LUT_A, LUT_A, 3), np.float32)
    for imax in range(3):
        S, A, B = np.meshgrid(s, a, a, indexing='ij')
        mx = S ** 2
        rgb = np.zeros(S.shape + (3,))
        o1, o2 = [j for j in range(3) if j != imax]
        rgb[..., imax] = mx
        rgb[..., o1] = A * mx
        rgb[..., o2] = B * mx
        c = fit_sigmoid_coeffs(rgb.reshape(-1, 3))
        out[imax] = c.reshape(LUT_S, LUT_A, LUT_A, 3)
    return out


def get_lut_np() -> np.ndarray:
    """The coefficient table (numpy): the shipped copy, else one fitted
    earlier into ``_build/``, else fitted now and written there."""
    global _LUT_CACHE
    if _LUT_CACHE is None:
        for path in (LUT_PATH, BUILT_LUT_PATH):
            if os.path.exists(path):
                _LUT_CACHE = np.load(path)['lut']
                break
        else:
            _LUT_CACHE = build_lut()
            os.makedirs(os.path.dirname(BUILT_LUT_PATH), exist_ok=True)
            np.savez_compressed(BUILT_LUT_PATH, lut=_LUT_CACHE)
    return _LUT_CACHE


def get_lut(device) -> torch.Tensor:
    """The coefficient table on ``device`` (uploaded once a device)."""
    key = str(device)
    if key not in _LUT_DEVICE:
        _LUT_DEVICE[key] = torch.as_tensor(get_lut_np(), device=device)
    return _LUT_DEVICE[key]


def srgb_model_eval(coeff, lam):
    """The sigmoid-polynomial reflectance model: coefficients (..., 3),
    wavelengths (..., L) -> (..., L)."""
    t = (lam - WAVELENGTH_MIN) * _SPAN_RCP
    v = (coeff[..., 0:1] * t + coeff[..., 1:2]) * t + coeff[..., 2:3]
    return m.clip(0.5 * v / m.sqrt(v * v + 1.0) + 0.5, 0.0, 1.0)


_OTHERS = ((1, 2), (0, 2), (0, 1))


def _lut_fetch(rgb):
    """Trilerped coefficients of rgb (N, 3) in [0, 1] -> (N, 3)."""
    lut = get_lut(rgb.device)
    rgb = m.clip(rgb, 1e-4, 1.0)
    imax = torch.argmax(rgb, dim=-1)                      # (N,)
    mx = rgb.amax(dim=-1)
    # the off-max components in build_lut's order
    oth = torch.as_tensor(_OTHERS, device=rgb.device)[imax]   # (N, 2)
    oth1 = torch.gather(rgb, 1, oth[:, 0:1])[:, 0] / mx
    oth2 = torch.gather(rgb, 1, oth[:, 1:2])[:, 0] / mx
    fs = (m.sqrt(mx) - _S0) * _S_SCALE
    fa = oth1 * (LUT_A - 1)
    fb = oth2 * (LUT_A - 1)
    fs = m.clip(fs, 0.0, LUT_S - 1 - 1e-4)
    fa = m.clip(fa, 0.0, LUT_A - 1 - 1e-4)
    fb = m.clip(fb, 0.0, LUT_A - 1 - 1e-4)
    i_s, i_a, i_b = (x.to(torch.int32).long() for x in (fs, fa, fb))
    ws, wa, wb = fs - i_s, fa - i_a, fb - i_b
    out = 0.0
    for ds in (0, 1):
        for da in (0, 1):
            for db in (0, 1):
                w = ((ws if ds else 1 - ws) * (wa if da else 1 - wa)
                     * (wb if db else 1 - wb))
                out = out + w[:, None] * lut[imax, i_s + ds, i_a + da,
                                             i_b + db]
    return out


def upsample_reflectance(rgb, lam):
    """rgb (N, 3) in [0, 1] and wavelengths (N, L) -> reflectance samples
    (N, L) whose D65-weighted CIE integral reproduces rgb."""
    coeff = _lut_fetch(rgb)
    val = srgb_model_eval(coeff, lam)
    # exact zeros stay zero (black reflectors must not leak energy)
    return torch.where((rgb.amax(dim=-1) > 1e-5)[:, None], val, 0.0)


def upsample_weight(rgb, lam):
    """Upsample an unbounded non-negative RGB quantity (a path weight or a
    radiance scale): normalise by the max component, upsample the chroma,
    scale back. Achromatic weights pass through exactly."""
    mx = rgb.amax(dim=-1)
    safe = m.clip(mx, min=1e-12)
    val = upsample_reflectance(rgb / safe[:, None], lam)
    return val * mx[:, None]


def cie_table_eval(tab, lam):
    """Lerp tables sampled on the CIE grid: tab (..., CIE_SAMPLES)
    broadcast against lam (..., L) -> (..., L). Wavelengths outside the
    grid clamp to its ends."""
    t = (lam - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    t = m.clip(t, 0.0, CIE_SAMPLES - 1.0)
    i0 = t.to(torch.int32).clamp(0, CIE_SAMPLES - 2).long()
    w1 = t - i0
    if tab.dim() < lam.dim():
        tab = tab.expand(lam.shape[:-1] + (tab.shape[-1],))
    v0 = torch.gather(tab, -1, i0)
    v1 = torch.gather(tab, -1, i0 + 1)
    return v0 * (1.0 - w1) + v1 * w1


def d65_eval(lam):
    """The normalised D65 SPD at wavelengths lam."""
    v0, v1, w1, ok = _table_lerp(_const(_D65_F32, lam), lam)
    return torch.where(ok, v0 * (1.0 - w1) + v1 * w1, 0.0)


def emitter_spectrum(rgb, lam):
    """The spectral radiance of an RGB emitter: upsampled chroma times
    the D65 illuminant (the srgb_d65 expansion)."""
    return upsample_weight(rgb, lam) * d65_eval(lam)


def planck(lam, temperature):
    """Planck's blackbody radiance in W / (m^2 sr nm); lam in nm."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lm = lam * 1e-9
    num = 2.0 * h * c * c
    return num / (lm ** 5 * torch.expm1(h * c / (lm * kb * temperature))) \
        * 1e-9

"""Spectral and polarized path tracer: a Mueller throughput a hero
wavelength.

Port of ``mitsuba_nlvrl_tpu/integrators/path_spectral_polarized.py``, the
``*_spectral_polarized`` variant: each lane carries 4 hero wavelengths and
a (4, 4) Mueller throughput for each, a state of (N, 4, 4, 4).

The polarized BSDF layer gives RGB-packed Mueller matrices. For each hero
wavelength the intensity m00 is upsampled with the spectral variant's
model, while the normalised structure M / m00 comes from the RGB band
that holds the wavelength (B below 490 nm, G below 580 nm, R above).
That is exact for achromatic structures (the ideal optical elements,
dielectrics of scalar IOR, diffuse). For named conductors with tabulated
eta/k curves both the magnitude and the structure (the phase
retardation) come a wavelength at a time from one curve gather
(``bsdf.polarized.spectral_conductor_terms``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import spectral as sp
from ..core.ray import Ray
from ..core.rng import Sampler
from ..bsdf import polarized as bpol
from .common import bounce_loop
from .path_polarized import (initial_fields, make_body,
                             sensor_frame_rotation)
from .path_spectral import emitted, hero_wavelengths


def _band_of(lam):
    """The RGB band of each wavelength: R = 0, G = 1, B = 2."""
    return torch.where(lam < 490.0, 2, torch.where(lam < 580.0, 1, 0))


def mueller_to_spectral(M_rgb, lam):
    """(N, 3, 4, 4) RGB Mueller and (N, H) wavelengths -> (N, H, 4, 4):
    upsampled m00 times the band's normalised structure."""
    m00 = m.clip(M_rgb[..., 0, 0], min=0.0)               # (N, 3)
    s = sp.upsample_weight(m00, lam)                          # (N, H)
    band = _band_of(lam).long()                               # (N, H)
    idx = band[..., None, None].expand(band.shape + (4, 4))
    M_b = torch.gather(M_rgb, 1, idx)                         # (N, H, 4, 4)
    m00_b = torch.gather(m00, 1, band)
    P = M_b * m.safe_rcp(m00_b)[..., None, None]
    return torch.where((m00_b > 1e-12)[..., None, None],
                       s[..., None, None] * P, 0.0)


class SpecPolState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor     # (N, H, 4, 4) Mueller a hero wavelength
    result: torch.Tensor         # (N, H, 4) Stokes a hero wavelength
    eta: torch.Tensor
    depth: torch.Tensor
    active: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    prev_p: torch.Tensor


def sample_stokes_vec(scene, meta, sampler: Sampler, ray: Ray, active=None,
                      diff: bool = False, aux=None):
    """The spectral polarized L_i: (Stokes (N, H, 4), lam, inv_pdf, valid,
    sampler) in the implicit Stokes frame of each camera ray."""
    N = ray.o.shape[0]
    lam, inv_pdf, sampler = hero_wavelengths(sampler, N)

    def spectral_terms(si, wo, M_rgb, lam, null):
        M = mueller_to_spectral(M_rgb, lam)
        ov = bpol.spectral_conductor_terms(scene, meta, si, wo, lam,
                                           null_lane=null)
        if ov is not None:
            # the per-wavelength conductor terms: the Fresnel magnitude
            # ratio and the Mueller structure (phase retardation)
            ratio, use, Mw = ov
            M = M * ratio[..., None, None]
            M = torch.where(use[:, None, None, None], M[..., 0:1, 0:1] * Mw,
                            M)
        return M

    body, max_depth = make_body(scene, meta, spectral_terms)
    st = SpecPolState(sampler=sampler, ray=ray,
                      **initial_fields(ray, sp.N_HERO, active))
    st = bounce_loop(body, st, max_depth, diff, lam=lam, emitted=emitted)
    return st.result, lam, inv_pdf, torch.ones_like(st.active), st.sampler


def sample_full(scene, meta, sampler: Sampler, ray: Ray, active=None,
                diff: bool = False, aux=None):
    """The sensor-frame sRGB Stokes estimate: (Stokes (N, 3, 4), valid,
    sampler). Each component develops through the CIE curves like
    spectral radiance (S1-S3 are signed; the development is linear)."""
    spec, lam, inv_pdf, valid, sampler = sample_stokes_vec(
        scene, meta, sampler, ray, active, diff=diff, aux=aux)
    R = sensor_frame_rotation(scene, ray)          # (N, 4, 4)
    spec = torch.einsum('nij,nhj->nhi', R, spec)
    stokes = torch.stack(
        [sp.spectral_to_srgb(spec[..., c], lam, inv_pdf) for c in range(4)],
        dim=-1)                                    # (N, 3, 4)
    return stokes, valid, sampler


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    """The radiance-only entry (S0)."""
    stokes, valid, sampler = sample_full(scene, meta, sampler, ray, active,
                                         diff=diff, aux=aux)
    return stokes[:, :, 0], valid, sampler

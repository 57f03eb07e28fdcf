"""Image agreement between two renders of the same scene and seed.

The port's RNG reproduces the reference's stream, so two renders of one
scene (the port against the reference, or the card against the CPU) trace
the same light paths, and their images differ only where a last-bit
difference flipped a decision (Russian roulette, a hit at a triangle
edge). The gates:

- at least 99% of pixels agree within 1e-3 relative in every channel;
- the image means agree within 1e-3 relative;
- the measured ray counts agree within 0.1%;
- as a backstop, the per-pixel z-test of the reference's golden suite
  (tests/test_golden_suite.py::_z_test), Sidak-corrected over the pixels,
  with the variance taken from the reference's own passes.

The same gates hold for the volumetric integrators: the medium walks
compare uniform numbers against ratios of exponentials many times a
bounce, and ``log1p``/``exp`` may differ in the last bit between the card
and the CPU, yet on the 64x64 renders of ``chip_smoke.py`` every pixel
agreed within 1e-3 and the ray counts were equal (H100, 700 W).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from .. import film as film_mod
from ..render import preprocess, render_pass

PIXEL_RTOL = 1e-3
PIXEL_FRACTION = 0.99
MEAN_RTOL = 1e-3
RAYS_RTOL = 1e-3
Z_ALPHA = 0.01
Z_FRACTION = 0.99


def render_with_passes(scene, meta, seed: int, spp: int, aux=None):
    """(image (H, W, 3), per-pass images (spp, H, W, 3), measured rays), all
    numpy, with the pass keys of ``render``; a two-pass integrator renders
    with the maps ``aux``, or with its own preprocess's."""
    key = rng.PRNGKey(seed)
    if aux is None:
        aux = preprocess(scene, meta, seed)
    acc, passes, rays = None, [], 0.0
    for p in range(spp):
        img, nrays = render_pass(scene, meta, rng.fold_in(key, p), p, aux)
        acc = img if acc is None else acc + img
        passes.append(film_mod.develop(img).cpu().numpy())
        rays += float(nrays)
    return film_mod.develop(acc).cpu().numpy(), np.stack(passes), rays


def z_test(mean, spp, ref, ref_var, ref_spp):
    """Per-pixel two-sided p-values (the golden suite's scheme)."""
    var = np.maximum(ref_var, 1e-4)
    n_eff = 1.0 / (1.0 / spp + 1.0 / ref_spp)
    z = np.abs(mean - ref) * np.sqrt(n_eff / var)
    cdf = 0.5 * (1.0 + torch.erf(torch.as_tensor(z / math.sqrt(2.0),
                                                 dtype=torch.float64)))
    return 2.0 * (1.0 - cdf.numpy())


def agreement(img, ref, ref_passes, rays, ref_rays, scale=None) -> dict:
    """The gates' numbers for ``img`` against the reference ``ref``. A
    signed image (a Stokes component S1-S3, which crosses zero) takes its
    relative gates against ``scale``, the reference's S0 image: pixels
    within 1e-3 of the pixel's S0, the mean within 1e-3 of S0's mean."""
    mean_scale = abs(float(ref.mean())) if scale is None \
        else float(np.abs(scale).mean())
    scale = np.abs(ref) if scale is None else np.abs(scale)
    close = np.abs(img - ref) <= PIXEL_RTOL * scale + 1e-6
    spp = ref_passes.shape[0]
    p = z_test(img, spp, ref, ref_passes.var(axis=0, ddof=1), spp)
    alpha_c = 1.0 - (1.0 - Z_ALPHA) ** (1.0 / p.size)
    return {
        'pixels_within_1e-3': float(close.all(axis=-1).mean()),
        'mean': float(img.mean()), 'ref_mean': float(ref.mean()),
        'mean_rel': float(abs(img.mean() - ref.mean())
                          / max(mean_scale, 1e-12)),
        'rays': float(rays), 'ref_rays': float(ref_rays),
        'rays_rel': float(abs(rays - ref_rays) / max(ref_rays, 1.0)),
        'z_pass_fraction': float((p >= alpha_c).mean()),
        'finite': bool(np.isfinite(img).all()),
    }


def check(a: dict) -> None:
    """Raise AssertionError unless every gate of ``agreement`` holds."""
    assert a['finite'], a
    assert a['pixels_within_1e-3'] >= PIXEL_FRACTION, a
    assert a['mean_rel'] <= MEAN_RTOL, a
    assert a['rays_rel'] <= RAYS_RTOL, a
    assert a['z_pass_fraction'] >= Z_FRACTION, a


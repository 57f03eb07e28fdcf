"""Film accumulation: reconstruction-filtered sample splatting.

Port of ``mitsuba_nlvrl_tpu/film/__init__.py``. ``splat`` spreads each
sample at a continuous pixel position over its filter footprint with one
scatter-add a tap; the camera wavefront of the primal render holds
exactly one sample per pixel in row-major order, so there the footprint is
a fixed set of relative taps and ``splat_pixel_ordered`` sums shifted
images. A weight channel is accumulated alongside and divided out in
``develop``.
"""
from __future__ import annotations

import math as pymath

import torch
import torch.nn.functional as F

from ..core import math as m
from ..scene.types import FilmMeta

FILTER_RADII = {'box': 0.5, 'tent': 1.0, 'gaussian': 2.0, 'mitchell': 2.0,
                'catmullrom': 2.0, 'lanczos': 3.0}


def filter_eval(name: str, x: torch.Tensor) -> torch.Tensor:
    """1D filter kernels (separable), x = distance in pixels."""
    ax = torch.abs(x)
    if name == 'box':
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if name == 'tent':
        return m.clip(1.0 - ax, min=0.0)
    if name == 'gaussian':
        std = 0.5
        alpha = -1.0 / (2.0 * std * std)
        r = FILTER_RADII['gaussian']
        return m.clip(torch.exp(alpha * ax * ax)
                           - pymath.exp(alpha * r * r), min=0.0)
    if name in ('mitchell', 'catmullrom'):
        if name == 'mitchell':
            B = C = 1.0 / 3.0
        else:
            B, C = 0.0, 0.5
        x2 = ax * ax
        x3 = x2 * ax
        y1 = ((12.0 - 9.0 * B - 6.0 * C) * x3
              + (-18.0 + 12.0 * B + 6.0 * C) * x2 + (6.0 - 2.0 * B)) / 6.0
        y2 = ((-B - 6.0 * C) * x3 + (6.0 * B + 30.0 * C) * x2
              + (-12.0 * B - 48.0 * C) * ax + (8.0 * B + 24.0 * C)) / 6.0
        return torch.where(ax < 1.0, y1, torch.where(ax < 2.0, y2, 0.0))
    if name == 'lanczos':
        tau = 3.0
        return torch.where(ax < tau, torch.sinc(ax) * torch.sinc(ax / tau),
                           0.0)
    raise ValueError(name)


def splat(film: FilmMeta, pos: torch.Tensor, values: torch.Tensor,
          weights: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Accumulate N samples into image (H, W, C+1), differentiably in
    ``values`` and ``weights``.

    pos: (N, 2) continuous pixel coordinates (x, y); values (N, C);
    weights (N,) sample weights (0 disables a lane). Each of the filter's
    k x k taps is one out-of-place ``index_add`` (the order of the sums
    within a pixel is the device's)."""
    H, W = image.shape[0], image.shape[1]
    radius = FILTER_RADII[film.rfilter]
    k = 1 if film.rfilter == 'box' else int(pymath.ceil(2.0 * radius))
    N, C = values.shape
    if k > 1:
        base = torch.floor(pos - (0.5 * (k - 1) + 0.5) + 0.5)
    else:
        base = torch.floor(pos)
    base = base.to(torch.int32)
    vals_w = torch.cat([values, torch.ones((N, 1), dtype=values.dtype,
                                           device=values.device)], -1) \
        * weights[:, None]
    img = image.reshape(H * W, C + 1)
    for oy in range(k):
        for ox in range(k):
            px = base[:, 0] + ox
            py = base[:, 1] + oy
            if k == 1:
                w = torch.ones((N,), dtype=values.dtype, device=values.device)
            else:
                w = filter_eval(film.rfilter, px + 0.5 - pos[:, 0]) \
                    * filter_eval(film.rfilter, py + 0.5 - pos[:, 1])
            inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            w = torch.where(inside & (weights > 0), w, 0.0)
            flat = m.clip(py, 0, H - 1) * W + m.clip(px, 0, W - 1)
            img = img.index_add(0, flat.long(), vals_w * w[:, None])
    return img.reshape(H, W, C + 1)


def splat_pixel_ordered(film: FilmMeta, jitter: torch.Tensor,
                        values: torch.Tensor, image: torch.Tensor
                        ) -> torch.Tensor:
    """Splat one sample per pixel (row-major, at pixel + jitter).

    jitter: (N, 2) in [0,1); values (N, C); image (H, W, C+1)."""
    H, W = image.shape[0], image.shape[1]
    C = values.shape[1]
    radius = FILTER_RADII[film.rfilter]
    k = 1 if film.rfilter == 'box' else int(pymath.ceil(2.0 * radius))

    vals = torch.cat([values, torch.ones((values.shape[0], 1),
                                         dtype=values.dtype,
                                         device=values.device)], -1)
    vals = vals.reshape(H, W, C + 1)
    jx = jitter[:, 0].reshape(H, W)
    jy = jitter[:, 1].reshape(H, W)

    if k == 1:
        return image + vals

    # tap pixels p+d with |d + 0.5 - jitter| < radius for some jitter in
    # [0,1): d in [-ceil(r - 0.5), ceil(r - 0.5)]
    kk = int(pymath.ceil(radius - 0.5))
    img = image
    for dx in range(-kk, kk + 1):
        for dy in range(-kk, kk + 1):
            wx = filter_eval(film.rfilter, dx + 0.5 - jx)
            wy = filter_eval(film.rfilter, dy + 0.5 - jy)
            contrib = vals * (wx * wy)[..., None]
            # shift contrib by (dy, dx) into the image
            pad_y = (max(dy, 0), max(-dy, 0))
            pad_x = (max(dx, 0), max(-dx, 0))
            shifted = F.pad(contrib, (0, 0) + pad_x + pad_y)
            shifted = shifted[pad_y[1]:pad_y[1] + H, pad_x[1]:pad_x[1] + W]
            img = img + shifted
    return img


def new_image(film: FilmMeta, device=None) -> torch.Tensor:
    """(H, W, 4) zeros: rgb * weight and the weight."""
    return torch.zeros((film.height, film.width, 4),
                       dtype=torch.float32, device=device)


def develop(image: torch.Tensor) -> torch.Tensor:
    """Normalize by the accumulated filter weight (hdrfilm develop)."""
    w = image[..., -1:]
    return image[..., :-1] * m.safe_rcp(w)

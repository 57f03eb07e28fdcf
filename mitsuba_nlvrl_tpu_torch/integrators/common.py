"""Shared integrator machinery.

Port of ``mitsuba_nlvrl_tpu/integrators/common.py``: one flat wavefront of
film-size rays per pass, bounce loops over masked lanes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import math as m


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    w = m.safe_div(pdf_a, pdf_a + pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0)


def film_sample_positions(meta, key, pass_idx=0, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample per pixel: continuous positions (N,2) in pixel units and
    the [0,1)^2 normalized sample position for the sensor."""
    from ..sampler import film_jitter
    W, H = meta.film.width, meta.film.height
    xs = torch.arange(W, dtype=torch.float32, device=device)
    ys = torch.arange(H, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')          # (H, W)
    base = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (N, 2)
    jitter = film_jitter(meta.sampler, key, pass_idx, meta.spp,
                         base.shape[0], device)
    pos = base + jitter
    scale = torch.tensor([1.0 / W, 1.0 / H], dtype=torch.float32,
                         device=device)
    return pos, pos * scale


def russian_roulette(throughput, eta, depth, rr_depth, u):
    """Returns (survive_mask, updated_throughput):
    q = min(max(throughput) * eta^2, 0.95), applied from rr_depth."""
    tmax = throughput.amax(dim=-1) * eta * eta
    q = torch.clamp(tmax, max=0.95)
    apply = depth >= rr_depth
    survive = torch.where(apply, u < q, True)
    thr = torch.where((apply & survive)[..., None],
                      throughput * m.safe_rcp(q)[..., None], throughput)
    return survive, thr

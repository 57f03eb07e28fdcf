"""Shared integrator machinery.

Port of ``mitsuba_nlvrl_tpu/integrators/common.py``: one flat wavefront of
film-size rays per pass, bounce loops over masked lanes.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core import math as m
from ..core import remat
from ..core.sync import any_on_host


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
    q = min(max(throughput) * eta^2, 0.95), applied from rr_depth. The
    survival probability is detached, as in the reference, so autograd
    does not differentiate the roulette's weight."""
    tmax = (throughput.amax(dim=-1) * eta * eta).detach()
    q = m.clip(tmax, max=0.95)
    apply = depth >= rr_depth
    survive = torch.where(apply, u < q, True)
    thr = torch.where((apply & survive)[..., None],
                      throughput * m.safe_rcp(q)[..., None], throughput)
    return survive, thr


def initial_active(active, N: int, device) -> torch.Tensor:
    """The lanes a wavefront starts with: ``active``, or all of them."""
    if active is None:
        return torch.ones((N,), dtype=torch.bool, device=device)
    return active


def bounce_loop(body, st, trips, diff: bool = False, **kw):
    """The reference's bounce loop over a state with an ``active`` mask.
    The primal render's is its ``lax.while_loop``: a host loop that reads
    ``any(active)`` back once a trip, for at most ``trips`` trips. Under
    ``diff`` the reference scans ``trips`` bounces, each under
    ``jax.checkpoint``; here each bounce runs under
    ``core/remat.checkpoint``. Every update of a bounce is masked by
    ``active``, so a trip in which no lane is active changes nothing, and
    the diff loop too stops at the first such trip."""
    step = functools.partial(body, **kw)
    it = 0
    while it < trips and any_on_host(st.active):
        st = remat.checkpoint(step, st) if diff else step(st)
        it += 1
    return st

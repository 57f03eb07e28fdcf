"""Photon-map radiance estimates over the hash grid.

Port of ``mitsuba_nlvrl_tpu/integrators/photon_est.py``:
  estimate_surface: the sum of power * f_r over photons within r, times
      scale / (pi r^2); caustic photons with the cone weight 1 - d/r and
      a factor 3;
  estimate_volume: phase-weighted, Epanechnikov-squared kernel
      3/pi (1 - d^2/r^2)^2 / r^2.

Every estimator fetches a whole photon in one row gather from the packed
maps (``maps.sp_packed``, ``maps.vp_packed``) and visits the 27 cells
around the query through ``ops/hashgrid.py``. The BSDFs this slice has
are diffuse on every smooth surface, so f_r / |cos| is a constant of the
query in each hemisphere and is evaluated twice a query instead of once a
photon (the reference's diffuse-only fast path; its per-photon path
serves BSDF types that come with ROADMAP item 7). In an isotropic-phase
scene the volume estimate skips the per-photon phase evaluation (1/4pi).
"""
from __future__ import annotations

import torch

from ..core import math as m
from .. import bsdf as bsdf_mod
from .. import phase as phase_mod
from ..ops import hashgrid
from ..scene.types import PHASE_TYPES


def _phase_isotropic_only(meta) -> bool:
    return all(t == PHASE_TYPES['isotropic'] for t in meta.phase_types)


def estimate_surface(scene, meta, maps, si, active, radius, caustic: bool,
                     max_per_cell: int = 32):
    """Density estimate of the caustic or global map at the camera-side
    surface interaction ``si``."""
    grid = maps.caustic_grid if caustic else maps.global_grid
    r2 = radius * radius
    inv_r2 = 1.0 / r2
    N = si.p.shape[0]
    dev = si.p.device
    n = si.sh_frame.n
    # f(wi, wo) / |cos wo| of a diffuse lobe depends on the hemisphere of
    # wo only: evaluate it at wo = (0, 0, +-1)
    up = torch.cat([torch.zeros((N, 2), device=dev),
                    torch.ones((N, 1), device=dev)], dim=-1)
    f_up = bsdf_mod.eval(scene, meta, si, up)
    f_dn = bsdf_mod.eval(scene, meta, si, -up)

    def fold(acc, idx, ok):
        rows = maps.sp_packed[idx]                   # (N, K, 12)
        d2 = m.squared_norm(rows[..., 0:3] - si.p[:, None, :])
        sel = ok & (d2 <= r2) & (rows[..., 10] > 0.5) \
            & ((rows[..., 9] > 0.5) == caustic)
        cos_o = m.dot(-rows[..., 3:6], n[:, None, :])
        f = torch.where((cos_o > 0)[..., None], f_up[:, None, :],
                        f_dn[:, None, :])
        w = torch.ones_like(d2)
        if caustic:
            w = torch.clamp(1.0 - m.safe_sqrt(d2 * inv_r2), min=0.0)
        contrib = rows[..., 6:9] * f * w[..., None]
        return acc + torch.where(sel[..., None], contrib, 0.0).sum(dim=1)

    acc = hashgrid.fold_neighbors(grid, si.p, active, fold,
                                  torch.zeros((N, 3), device=dev),
                                  max_per_cell)
    k = 3.0 if caustic else 1.0
    return acc * (k * maps.sp_scale * m.InvPi * inv_r2)


def estimate_volume(scene, meta, maps, x, wo, medium_idx, active, radius,
                    max_per_cell: int = 32):
    """Volume photon estimate at the gather point x with outgoing
    direction wo; ``radius`` per lane. The caller applies the map's
    scale."""
    r2 = (radius * radius).expand(x.shape[:-1])[:, None]
    iso = _phase_isotropic_only(meta)

    def fold(acc, idx, ok):
        rows = maps.vp_packed[idx]                   # (N, K, 12)
        d2 = m.squared_norm(rows[..., 0:3] - x[:, None, :])
        sel = ok & (d2 <= r2) & (rows[..., 10] > 0.5)
        if iso:
            pf = torch.full(idx.shape, m.InvFourPi, device=x.device)
        else:
            K = idx.shape[1]
            # phase(wi = -photon direction -> wo)
            pf = phase_mod.eval(
                scene, meta, medium_idx.repeat_interleave(K),
                -rows[..., 3:6].reshape(-1, 3), wo.repeat_interleave(K, 0),
                torch.ones((idx.numel(),), dtype=torch.bool,
                           device=x.device)).reshape(idx.shape)
        kern = m.sqr(1.0 - d2 / r2) / r2 * m.InvPi * 3.0
        contrib = rows[..., 6:9] * (pf * kern)[..., None]
        return acc + torch.where(sel[..., None], contrib, 0.0).sum(dim=1)

    return hashgrid.fold_neighbors(maps.vp_grid, x, active, fold,
                                   torch.zeros(x.shape[:-1] + (3,),
                                               device=x.device),
                                   max_per_cell)

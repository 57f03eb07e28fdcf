"""Photon-map radiance estimates over the hash grid.

Port of ``mitsuba_nlvrl_tpu/integrators/photon_est.py``:
  estimate_surface: the sum of power * f_r over photons within r, times
      scale / (pi r^2); caustic photons with the cone weight 1 - d/r and
      a factor 3;
  estimate_volume: phase-weighted, Epanechnikov-squared kernel
      3/pi (1 - d^2/r^2)^2 / r^2.

  estimate_beam: the beam radiance estimate along a camera segment,
      marched in 2r steps with a midpoint-rule optical depth.

Every estimator fetches a whole photon in one row gather from the packed
maps (``maps.sp_packed``, ``maps.vp_packed``) and visits the 27 cells
around the query through ``ops/hashgrid.py``. When every BSDF of the
scene is diffuse where it gathers (``_gather_diffuse_only``), f_r / |cos|
is a constant of the query in each hemisphere and is evaluated twice a
query instead of once a photon; scenes with rough or plastic surfaces
evaluate the BSDF once a photon. In an isotropic-phase scene the volume
and beam estimates skip the per-photon phase evaluation (1/4pi).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.sync import int_on_host
from .. import bsdf as bsdf_mod
from .. import medium as medium_mod
from .. import phase as phase_mod
from ..ops import hashgrid
from ..scene.types import BSDF_TYPES, PHASE_TYPES

# BSDF types that can end a camera path at a smooth (gathering) surface
# with a lobe that is not diffuse: with any of them present f / |cos|
# varies from photon to photon
_NON_DIFFUSE_SMOOTH = tuple(
    code for name, code in BSDF_TYPES.items()
    if name not in ('diffuse', 'conductor', 'dielectric',
                    'thindielectric', 'null'))


def _gather_diffuse_only(meta) -> bool:
    return not any(t in _NON_DIFFUSE_SMOOTH for t in meta.bsdf_types)


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
    fr = si.sh_frame
    fast = _gather_diffuse_only(meta)
    if fast:
        # f(wi, wo) / |cos wo| of a diffuse lobe depends on the hemisphere
        # of wo only: evaluate it at wo = (0, 0, +-1)
        up = torch.cat([torch.zeros((N, 2), device=dev),
                        torch.ones((N, 1), device=dev)], dim=-1)
        f_up = bsdf_mod.eval(scene, meta, si, up)
        f_dn = bsdf_mod.eval(scene, meta, si, -up)

    def fold(acc, idx, ok):
        rows = maps.sp_packed[idx]                   # (N, K, 12)
        d2 = m.squared_norm(rows[..., 0:3] - si.p[:, None, :])
        sel = ok & (d2 <= r2) & (rows[..., 10] > 0.5) \
            & ((rows[..., 9] > 0.5) == caustic)
        v = -rows[..., 3:6]                          # toward the photon
        cos_o = m.dot(v, fr.n[:, None, :])
        if fast:
            f = torch.where((cos_o > 0)[..., None], f_up[:, None, :],
                            f_dn[:, None, :])
        else:
            K = idx.shape[1]
            wo_local = torch.stack(
                [m.dot(v, fr.s[:, None, :]), m.dot(v, fr.t[:, None, :]),
                 cos_o], dim=-1)                     # (N, K, 3)
            # every field a textured lobe reads, repeated per photon (the
            # shading frame is not, as in the reference)
            rep = lambda a: a.repeat_interleave(K, 0)  # noqa: E731
            si_flat = si._replace(
                wi=rep(si.wi), bsdf_idx=rep(si.bsdf_idx), uv=rep(si.uv),
                p=rep(si.p), prim_index=rep(si.prim_index),
                shape_idx=rep(si.shape_idx), valid=rep(si.valid))
            f = bsdf_mod.eval(scene, meta, si_flat,
                              wo_local.reshape(N * K, 3)).reshape(N, K, 3)
            # the density estimate wants f_r alone: divide out the folded
            # cosine (the photon density already carries it)
            f = f / m.clip(torch.abs(cos_o), min=1e-3)[..., None]
        w = torch.ones_like(d2)
        if caustic:
            w = m.clip(1.0 - m.safe_sqrt(d2 * inv_r2), min=0.0)
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


def estimate_beam(scene, meta, maps, o, d, t_max, wo, medium_idx, active,
                  radius, n_steps: int, max_per_cell: int = 32):
    """Beam radiance estimate along the segments (o, d, t_max): volume
    photons within their own radius (``vp_packed`` column 9) of the line
    contribute power * phase * K2(d_perp / r) / r^2 * Tr(closest
    approach). The segment is marched in steps of 2 ``radius``
    (``n_steps`` at most); each step folds the 27 cells around its
    midpoint and counts the photons whose closest approach falls inside
    it, so none counts twice. Tr integrates each step's midpoint
    extinction (a midpoint rule, exact for homogeneous media). The steps
    no lane reaches are not run (one host read)."""
    N = o.shape[0]
    dev = o.device
    step = (2.0 * radius).expand((N,))
    iso = _phase_isotropic_only(meta)
    need = active[:, None] & (
        torch.arange(n_steps, device=dev, dtype=torch.float32)[None, :]
        * step[:, None] < t_max[:, None])
    n_live = int_on_host(need.sum(dim=1).amax())
    tau = torch.zeros((N, 3), device=dev)
    acc = torch.zeros((N, 3), device=dev)
    for g in range(n_live):
        t0 = g * step
        t1 = torch.minimum(t0 + step, t_max)
        ok_step = active & (t0 < t_max)
        x = o + d * (0.5 * (t0 + t1))[:, None]
        _, _, st_mid = medium_mod.get_scattering_coefficients(
            scene, meta, medium_idx, x, ok_step)

        def fold(inner, idx, okk):
            rows = maps.vp_packed[idx]               # (N, K, 12)
            rel = rows[..., 0:3] - o[:, None, :]
            t_p = m.dot(rel, d[:, None, :])          # closest approach
            perp2 = m.squared_norm(rel) - t_p * t_p
            rr2 = m.sqr(rows[..., 9])
            sel = okk & (rows[..., 10] > 0.5) & (perp2 <= rr2) \
                & (t_p >= t0[:, None]) & (t_p < t1[:, None]) \
                & (t_p >= 0) & (t_p <= t_max[:, None])
            if iso:
                pf = torch.full(idx.shape, m.InvFourPi, device=dev)
            else:
                K = idx.shape[1]
                pf = phase_mod.eval(
                    scene, meta, medium_idx.repeat_interleave(K),
                    -rows[..., 3:6].reshape(-1, 3), wo.repeat_interleave(K, 0),
                    torch.ones((idx.numel(),), dtype=torch.bool, device=dev)
                ).reshape(idx.shape)
            kern = m.sqr(1.0 - perp2 / rr2) / rr2 * m.InvPi * 3.0
            # Tr to the closest approach: the completed steps' depth plus
            # this step's midpoint extinction up to it
            depth = tau[:, None, :] + m.clip(
                t_p - t0[:, None], min=0.0)[..., None] * st_mid[:, None, :]
            contrib = rows[..., 6:9] * (pf * kern)[..., None] \
                * torch.exp(-depth)
            return inner + torch.where(sel[..., None], contrib,
                                       0.0).sum(dim=1)

        acc = acc + hashgrid.fold_neighbors(
            maps.vp_grid, x, ok_step, fold, torch.zeros((N, 3), device=dev),
            max_per_cell)
        tau = tau + torch.where(ok_step[:, None],
                                (t1 - t0)[:, None] * st_mid, 0.0)
    return acc

"""Nonlinear medium: rays bend through a voxel grid of IOR values.

Port of ``mitsuba_nlvrl_tpu/medium/nonlinear.py``. A regular voxel grid
over the medium's bbox holds one IOR a cell; a ray marching through it
refracts (Snell) or reflects (total internal reflection) at every cell
boundary, which makes piecewise-linear curved rays. The cell of a point is
index arithmetic, the exit face and its normal come from the slab test
against the cell's box, and the flat index is (x * ry + y) * rz + z, the
layout the builder voxelises (``scene/builder.py``).

The reference's ``lax.while_loop`` over bends becomes a host loop that
reads ``any(active)`` back once a bend (``core/sync.py``); every lane stays
in place and masked. With ``stop_at_scene`` each bend makes one
nearest-hit call through the intersection kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core.ray import Ray
from ..core.records import SurfaceInteraction
from ..core.sync import any_on_host
from ..ops import intersect as isect
from ..scene.types import M_BBOX_MIN, M_BBOX_MAX, M_NL_RES, MEDIUM_TYPES

MT_NONLINEAR = MEDIUM_TYPES['nonlinear']


class NonLinearInteraction(NamedTuple):
    """The next cell-boundary bend event of each lane."""
    valid: torch.Tensor   # (N,) bool
    t: torch.Tensor       # (N,) distance to the cell boundary (+eps)
    p: torch.Tensor       # (N, 3) boundary point
    wi: torch.Tensor      # (N, 3) incoming propagation direction
    wo: torch.Tensor      # (N, 3) bent outgoing direction
    n: torch.Tensor       # (N, 3) boundary face normal (against wi)
    n1: torch.Tensor      # (N,) IOR of the current cell
    n2: torch.Tensor      # (N,) IOR of the neighbour cell
    eta: torch.Tensor     # (N,) relative IOR of the event


def _nl_grid_info(scene, medium_idx):
    P = scene.media.params[m.clip(medium_idx, min=0).long()]
    lo = P[:, M_BBOX_MIN:M_BBOX_MIN + 3]
    hi = P[:, M_BBOX_MAX:M_BBOX_MAX + 3]
    res = m.clip(P[:, M_NL_RES:M_NL_RES + 3].to(torch.int32), min=1)
    cell = (hi - lo) / res.to(torch.float32)
    return lo, hi, res, cell


def _cell_ior(scene, c, res):
    flat = (c[:, 0] * res[:, 1] + c[:, 1]) * res[:, 2] + c[:, 2]
    n = scene.media.nl_ior.shape[0]
    return scene.media.nl_ior[m.clip(flat, 0, n - 1).long()]


def sample_nonlinear_interaction(scene, meta, ray: Ray, medium_idx, active
                                 ) -> NonLinearInteraction:
    """The next cell-boundary bend event of each lane. Invalid where the
    lane is not in a nonlinear medium, its origin lies outside the grid,
    or the crossed face leaves the grid (flat axes with res 1 included)."""
    lo, hi, res, cell = _nl_grid_info(scene, medium_idx)
    midx = m.clip(medium_idx, min=0).long()
    is_nl = (scene.media.type[midx] == MT_NONLINEAR) & (medium_idx >= 0)

    p0 = ray.at(ray.mint)
    inside = ((p0 >= lo) & (p0 <= hi)).all(dim=-1)
    act = active & is_nl & inside

    c = torch.floor((p0 - lo) / m.clip(cell, min=1e-30)).to(torch.int32)
    c = torch.minimum(m.clip(c, min=0), res - 1)
    n1 = _cell_ior(scene, c, res)

    # slab test against the current cell's box: exit distance and axis
    cell_lo = lo + c.to(torch.float32) * cell
    cell_hi = cell_lo + cell
    inv_d = 1.0 / ray.d
    t1 = (cell_lo - ray.o) * inv_d
    t2 = (cell_hi - ray.o) * inv_d
    t_far_axes = torch.maximum(t1, t2)
    exit_axis = torch.argmin(t_far_axes, dim=-1)
    t_exit = t_far_axes.amin(dim=-1)
    act = act & (t_exit > m.RayEpsilon) & torch.isfinite(t_exit) \
        & (t_exit <= ray.maxt)

    # face normal opposing the ray: -sign(d[axis]) on the exit axis
    step_sign = torch.sign(ray.d.gather(-1, exit_axis[:, None])[:, 0])
    step_sign = torch.where(step_sign == 0, 1.0, step_sign)
    one_hot = torch.nn.functional.one_hot(exit_axis, 3)
    normal = -step_sign[:, None] * one_hot.to(ray.d.dtype)

    # the neighbour cell along the travel direction
    c_nb = c + step_sign.to(torch.int32)[:, None] * one_hot.to(torch.int32)
    act = act & ((c_nb >= 0) & (c_nb < res)).all(dim=-1)
    n2 = _cell_ior(scene, torch.minimum(m.clip(c_nb, min=0), res - 1),
                   res)

    # refract, or reflect at total internal reflection
    eta_rel = n1 / m.clip(n2, min=1e-6)
    wo_refr, tir = m.refract_snell(ray.d, normal, eta_rel)
    wo_refl = ray.d - 2.0 * m.dot(ray.d, normal, keepdims=True) * normal
    wo = torch.where(tir[:, None], wo_refl, wo_refr)
    eta = torch.where(tir, 1.0, eta_rel)

    t_evt = t_exit + m.RayEpsilon
    p_evt = ray.at(t_evt)
    # no bend where the IORs are equal: wo stays ray.d
    same = torch.abs(n1 - n2) < 1e-7
    wo = torch.where(same[:, None], ray.d, wo)

    return NonLinearInteraction(
        valid=act, t=torch.where(act, t_evt, m.Infinity), p=p_evt,
        wi=ray.d, wo=m.normalize(wo), n=normal, n1=n1, n2=n2,
        eta=torch.where(act, eta, 1.0))


class BentRay(NamedTuple):
    """Piecewise-linear curved ray: fixed-capacity segment arrays and a
    count a lane."""
    seg_o: torch.Tensor     # (N, S, 3) segment origins
    seg_d: torch.Tensor     # (N, S, 3) unit directions
    seg_len: torch.Tensor   # (N, S) lengths (0 for unused slots)
    count: torch.Tensor     # (N,) int32 number of segments
    total: torch.Tensor     # (N,) total length

    def at(self, t):
        """Point at curve parameter t (N,)."""
        S = self.seg_len.shape[1]
        cum = torch.cumsum(self.seg_len, dim=1)
        prev = cum - self.seg_len
        last = torch.arange(S, device=t.device)[None, :] \
            < (self.count[:, None] - 1)
        idx = ((t[:, None] >= cum) & last).sum(dim=1)
        idx = m.clip(idx, 0, S - 1)[:, None]
        local_t = t - prev.gather(1, idx)[:, 0]
        i3 = idx[:, :, None].expand(-1, 1, 3)
        o = self.seg_o.gather(1, i3)[:, 0]
        d = self.seg_d.gather(1, i3)[:, 0]
        return o + d * local_t[:, None]


def _where_hit(mask, new, old):
    return type(new)(*(torch.where(mask.reshape(mask.shape + (1,)
                                                * (a.dim() - 1)), a, b)
                       for a, b in zip(new, old)))


def bend_ray(scene, meta, ray: Ray, medium_idx, active, max_segments: int,
             max_dist=None, stop_at_scene: bool = False):
    """March a wavefront of rays through the nonlinear grid, building
    curved rays. Segments end at cell boundaries; the last one ends at
    ``max_dist``, at the first scene hit (``stop_at_scene``) or at the grid
    boundary.

    Returns (BentRay, si): ``si`` is the SurfaceInteraction that ends the
    curve (invalid where it ended for another reason); only meaningful
    with ``stop_at_scene``."""
    N = ray.o.shape[0]
    dev = ray.o.device
    S = max_segments
    if max_dist is None:
        max_dist = torch.full((N,), m.Infinity, device=dev)

    seg_o = torch.zeros((N, S, 3), device=dev)
    seg_d = torch.zeros((N, S, 3), device=dev)
    seg_len = torch.zeros((N, S), device=dev)
    count = torch.zeros((N,), dtype=torch.int32, device=dev)
    total = torch.zeros((N,), device=dev)
    # the loop keeps the preliminary hit only; the full interaction is
    # resolved once after it, for the hit that ends the curve
    pi_acc = isect.PreliminaryHit(
        valid=torch.zeros((N,), dtype=torch.bool, device=dev),
        t=torch.full((N,), m.Infinity, device=dev),
        prim_idx=torch.full((N,), -1, dtype=torch.int32, device=dev),
        kind=torch.zeros((N,), dtype=torch.int32, device=dev),
        u=torch.zeros((N,), device=dev), v=torch.zeros((N,), device=dev))
    hit_o = torch.zeros((N, 3), device=dev)
    hit_d = torch.zeros((N, 3), device=dev)
    zeros = torch.zeros((N,), device=dev)
    no_hit = torch.zeros((N,), dtype=torch.bool, device=dev)

    cur = Ray(ray.o, ray.d, ray.mint, ray.maxt)
    act = active
    i = 0
    while i < S and any_on_host(act):
        remaining = max_dist - total
        seg_ray = Ray(cur.o, cur.d, cur.mint, remaining)
        nli = sample_nonlinear_interaction(scene, meta, seg_ray, medium_idx,
                                           act)
        if stop_at_scene:
            pi = isect.intersect_preliminary(scene, seg_ray)
            hit_first = act & pi.valid & (pi.t < nli.t)
            pi_acc = _where_hit(hit_first, pi, pi_acc)
            hit_o = torch.where(hit_first[:, None], cur.o, hit_o)
            hit_d = torch.where(hit_first[:, None], cur.d, hit_d)
            hit_t = pi.t
        else:
            hit_first, hit_t = no_hit, zeros
        bend = act & nli.valid & ~hit_first
        seg_end_t = torch.where(
            bend, nli.t, torch.where(hit_first, hit_t,
                                     m.clip(remaining, max=1e8)))
        seg_o[:, i] = torch.where(act[:, None], cur.o, seg_o[:, i])
        seg_d[:, i] = torch.where(act[:, None], cur.d, seg_d[:, i])
        seg_len[:, i] = torch.where(act, seg_end_t, seg_len[:, i])
        count = torch.where(act, i + 1, count)
        total = torch.where(act, total + seg_end_t, total)
        cur = Ray(o=torch.where(bend[:, None], nli.p, cur.o),
                  d=torch.where(bend[:, None], nli.wo, cur.d),
                  mint=zeros, maxt=cur.maxt)
        act = bend
        i += 1
    if stop_at_scene:
        si_out = isect.compute_si(
            scene, Ray(hit_o, hit_d, zeros,
                       torch.full((N,), m.Infinity, device=dev)), pi_acc)
    else:
        si_out = SurfaceInteraction.invalid((N,), dev)
    return BentRay(seg_o=seg_o, seg_d=seg_d, seg_len=seg_len, count=count,
                   total=total), si_out

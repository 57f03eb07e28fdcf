"""Participating media: homogeneous, heterogeneous (grid) and nonlinear.

Port of ``mitsuba_nlvrl_tpu/medium/__init__.py``. Every function takes a
per-lane ``medium_idx`` (-1 = vacuum) and dispatches masked over the few
medium types a scene holds (``SceneMeta.medium_types``).
A nonlinear medium is optically homogeneous (its IOR grid bends rays,
``medium/nonlinear.py``; its extinction is constant), so everything here
that is not the heterogeneous walk treats it in closed form, as it treats
a homogeneous one.

The collision walk ``_majorant_walk`` is the reference's: delta tracking
(to the next real collision) or ratio tracking (transmittance) against
supervoxel-local majorants, with decomposition tracking (each block's
constant control drawn analytically) and empty-space leaps over vacuum
blocks, one corner-packed row gather a tracking event. Its
``lax.while_loop`` becomes a host loop that reads ``any(walking)`` back
once every ``WALK_UNROLL`` masked events, and it draws the reference's
random numbers: ``uniform(fold_in(key, it), (WALK_UNROLL, N, n_u))`` per
trip, with ``it`` counting events. Every lane stays in place and masked,
so a lane's random numbers do not depend on the others.

Under ``diff`` (the differentiable render) the density is read from
``grid_sigma_t`` itself, not from its corner-packed copy, so gradients
reach the grid, and the block bounds come from ``grid_sup`` and
``grid_sup_min``. The walk is then the reference's bounded, checkpointed
scan: at most ``ceil(min(max_steps, 192) / WALK_UNROLL)`` trips, each
recomputed during the backward pass. A lane still walking at that bound
is cut as the primal walk cuts one at ``max_steps``: this truncation is
part of the reference's diff-mode estimator.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..core import math as m
from ..core import remat
from ..core import rng
from ..core.ray import Ray
from ..core.records import MediumInteraction
from ..core.sync import any_on_host
from ..scene.types import (MEDIUM_TYPES, M_SIGMA_T, M_ALBEDO, M_SCALE,
                           M_BBOX_MIN, M_BBOX_MAX, M_MAJORANT)

MT_HETEROGENEOUS = MEDIUM_TYPES['heterogeneous']

# tracking events folded into each trip of the walk loop (one host read
# of any(walking) a trip)
WALK_UNROLL = 8
# ratio-tracking Russian roulette: below this carried weight, a collision
# survives with p = w / RR_TR_THRESH and is rescaled by 1/p (unbiased;
# bounds a shadow walk through an optically thick core)
RR_TR_THRESH = 0.03
# fold_in constant of the first control collision; not a multiple of
# WALK_UNROLL, so it never meets a trip's fold
_CTRL0_FOLD = 0x7ffffff1
# tracking events of a walk under ``diff``, at most (the reference's scan)
DIFF_WALK_EVENTS = 192


@functools.lru_cache(maxsize=64)
def _const3(values: Tuple[float, float, float], device) -> torch.Tensor:
    """A (3,) float32 constant on ``device``, made once: a host-to-device
    copy inside the walk would wait for the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _rows(scene, medium_idx):
    """(params (N, MEDIUM_NPARAM), type (N,)) of each lane's medium
    (``index_select``: its backward is one scatter-add)."""
    midx = m.clip(medium_idx, min=0).long()
    return (scene.media.params.index_select(0, midx),
            scene.media.type.index_select(0, midx))


def _trilinear(shape, lo, hi, p):
    """Cell-centred trilinear setup over a (Dz, Dy, Dx) grid on [lo, hi]:
    (inside, base voxel (z0, y0, x0) int32, tz, ty, tx), edge-clamped."""
    Dz, Dy, Dx = shape
    rel = (p - lo) / m.clip(hi - lo, min=1e-30)
    inside = ((rel >= 0.0) & (rel <= 1.0)).all(dim=-1)
    fx = m.clip(rel[..., 0] * Dx - 0.5, 0.0, Dx - 1.0)
    fy = m.clip(rel[..., 1] * Dy - 0.5, 0.0, Dy - 1.0)
    fz = m.clip(rel[..., 2] * Dz - 0.5, 0.0, Dz - 1.0)
    x0 = m.clip(fx.to(torch.int32), 0, Dx - 1)
    y0 = m.clip(fy.to(torch.int32), 0, Dy - 1)
    z0 = m.clip(fz.to(torch.int32), 0, Dz - 1)
    return (inside, (z0, y0, x0), fz - z0, fy - y0, fx - x0)


def _grid_lookup(grid, bbox_lo, bbox_hi, p):
    """Trilinear lookup of a (Dz, Dy, Dx) grid over the bbox (zero
    outside)."""
    Dz, Dy, Dx = grid.shape
    inside, (z0, y0, x0), tz, ty, tx = _trilinear(grid.shape, bbox_lo,
                                                  bbox_hi, p)
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    x1 = m.clip(x0 + 1, max=Dx - 1)
    y1 = m.clip(y0 + 1, max=Dy - 1)
    z1 = m.clip(z0 + 1, max=Dz - 1)
    # the eight corners in one gather of the flat grid (under autograd
    # its backward is one scatter-add, where eight 3-d index gathers
    # would each sort their indices)
    rows = [(z * Dy + y) * Dx for z in (z0, z1) for y in (y0, y1)]
    flat = torch.stack([r + x for r in rows for x in (x0, x1)])
    g = grid.reshape(-1).index_select(0, flat.reshape(-1)).reshape(
        flat.shape)
    c00 = m.lerp(g[0], g[1], tx)
    c01 = m.lerp(g[2], g[3], tx)
    c10 = m.lerp(g[4], g[5], tx)
    c11 = m.lerp(g[6], g[7], tx)
    c0 = m.lerp(c00, c01, ty)
    c1 = m.lerp(c10, c11, ty)
    return torch.where(inside, m.lerp(c0, c1, tz), 0.0)


def _packed_row(packed, shape, lo, hi, p):
    """(inside, the packed row of p's base voxel (N, 10), corner weights
    (N, 8)) over the corner-packed grid."""
    _, Dy, Dx = shape
    inside, (z0, y0, x0), tz, ty, tx = _trilinear(shape, lo, hi, p)
    rows = packed[((z0 * Dy + y0) * Dx + x0).long()]
    k = torch.arange(8, device=p.device)
    tz, ty, tx = tz[..., None], ty[..., None], tx[..., None]
    w = (torch.where(((k >> 2) & 1) > 0, tz, 1.0 - tz)
         * torch.where(((k >> 1) & 1) > 0, ty, 1.0 - ty)
         * torch.where((k & 1) > 0, tx, 1.0 - tx))
    return inside, rows, w


def _grid_lookup_packed(packed, shape, bbox_lo, bbox_hi, p):
    """Trilinear lookup through the corner-packed grid: one row gather
    and a weighted sum; the same result as ``_grid_lookup``."""
    inside, rows, w = _packed_row(packed, shape, bbox_lo, bbox_hi, p)
    return torch.where(inside, (rows[..., :8] * w).sum(dim=-1), 0.0)


def _sigma_grid_eval(scene, lo, hi, p, diff: bool = False):
    """Density at p: the packed grid where the scene has one, unless
    differentiating (the packed copy is derived at build time, so
    gradients must flow through ``grid_sigma_t`` itself)."""
    med = scene.media
    if med.grid_sigma_p8 is not None and not diff:
        return _grid_lookup_packed(med.grid_sigma_p8, med.grid_sigma_t.shape,
                                   lo, hi, p)
    return _grid_lookup(med.grid_sigma_t, lo, hi, p)


def with_sigma_grid(media, grid):
    """``media`` with a new density grid and its derived arrays refreshed:
    the supervoxel bounds and controls, and the corner-packed copy. Use
    it instead of ``media._replace(grid_sigma_t=...)``, which leaves the
    derived copies stale (the trackers would sample against wrong
    majorants). The derived arrays are built on the host from the grid's
    value; the new grid keeps no autograd history."""
    import numpy as np
    from ..scene.builder import (_PACK_MAX_VOXELS, _corner_pack,
                                 _supervoxel_max, _supervoxel_min)
    dev = media.grid_sigma_t.device
    g = np.asarray(torch.as_tensor(grid).detach().cpu(), np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)
    dense = g.size > 1
    return media._replace(
        grid_sigma_t=t(g),
        grid_sup=t(_supervoxel_max(g) if dense
                   else np.ones((1, 1, 1), np.float32)),
        grid_sup_min=t(_supervoxel_min(g) if dense
                       else np.zeros((1, 1, 1), np.float32)),
        grid_sigma_p8=(t(_corner_pack(g)) if 1 < g.size <= _PACK_MAX_VOXELS
                       else None))


def medium_bbox(scene, medium_idx):
    P, _ = _rows(scene, medium_idx)
    return (P[:, M_BBOX_MIN:M_BBOX_MIN + 3], P[:, M_BBOX_MAX:M_BBOX_MAX + 3])


def intersect_aabb(scene, meta, medium_idx, ray: Ray):
    """Medium extent along the ray: (hit, mint, maxt). Homogeneous media
    are unbounded (their extent is the enclosing null shape);
    heterogeneous media clip to the grid bbox. A zero direction component
    gives an infinite slab distance, or NaN (and a miss) on the slab's
    plane, as in the reference."""
    N = ray.o.shape[0]
    dev = ray.o.device
    mint = torch.zeros((N,), device=dev)
    maxt = torch.full((N,), m.Infinity, device=dev)
    hit = torch.ones((N,), dtype=torch.bool, device=dev)
    if MT_HETEROGENEOUS in meta.medium_types:
        P, mtype = _rows(scene, medium_idx)
        inv_d = 1.0 / ray.d
        lo = P[:, M_BBOX_MIN:M_BBOX_MIN + 3]
        hi = P[:, M_BBOX_MAX:M_BBOX_MAX + 3]
        if P.requires_grad:
            # the slab distances of a zero direction component are
            # infinite: there the bounds take no gradient (the
            # reference's is 0 * inf, a NaN, on such lanes, all masked)
            fin = torch.isfinite(inv_d)
            lo = torch.where(fin, lo, lo.detach())
            hi = torch.where(fin, hi, hi.detach())
        t0 = (lo - ray.o) * inv_d
        t1 = (hi - ray.o) * inv_d
        near = torch.minimum(t0, t1).amax(dim=-1)
        far = torch.maximum(t0, t1).amin(dim=-1)
        is_het = mtype == MT_HETEROGENEOUS
        hit = torch.where(is_het, near <= far, hit)
        mint = torch.where(is_het, near, mint)
        maxt = torch.where(is_het, far, maxt)
    return hit, mint, maxt


def _ch(vec, channel):
    """Hero-channel value of each lane: vec (N, 3), channel (N,) int."""
    return vec.gather(-1, channel.long()[:, None])[:, 0]


def _sup_static(scene):
    """Supervoxel facts (Sv, kv, Dv), each (3,) float32 in xyz order: the
    block counts, the builder's block edge in voxels (the last block may
    be short) and the voxel counts."""
    Sz, Sy, Sx = scene.media.grid_sup.shape
    Dz, Dy, Dx = scene.media.grid_sigma_t.shape
    dev = scene.media.grid_sup.device
    return (_const3((Sx, Sy, Sz), dev),
            _const3((-(-Dx // Sx), -(-Dy // Sy), -(-Dz // Sz)), dev),
            _const3((Dx, Dy, Dz), dev))


def _has_supervoxels(scene, meta):
    return (MT_HETEROGENEOUS in meta.medium_types
            and scene.media.grid_sup.numel() > 1)


def block_index_of(scene, meta, medium_idx, p):
    """Supervoxel block index (N, 3) xyz of world point p."""
    P, _ = _rows(scene, medium_idx)
    lo = P[:, M_BBOX_MIN:M_BBOX_MIN + 3]
    hi = P[:, M_BBOX_MAX:M_BBOX_MAX + 3]
    Sv, kv, Dv = _sup_static(scene)
    rel = (p - lo) / m.clip(hi - lo, min=1e-30)
    return torch.minimum(m.clip(torch.floor(rel * Dv / kv), min=0.0),
                         Sv - 1.0).to(torch.int32)


def _dda_init(scene, meta, medium_idx, ray: Ray, mint):
    """3D-DDA state over the supervoxel grid at the segment entry: (block
    index (N, 3) int32, absolute next crossing t per axis (N, 3), crossing
    period per axis (N, 3)). Without supervoxels the crossings are
    infinite and the walk tracks against the global majorant."""
    N = ray.o.shape[0]
    dev = ray.o.device
    if not _has_supervoxels(scene, meta):
        inf3 = torch.full((N, 3), m.Infinity, device=dev)
        return torch.zeros((N, 3), dtype=torch.int32, device=dev), inf3, inf3
    P, _ = _rows(scene, medium_idx)
    lo = P[:, M_BBOX_MIN:M_BBOX_MIN + 3]
    hi = P[:, M_BBOX_MAX:M_BBOX_MAX + 3]
    Sv, kv, Dv = _sup_static(scene)
    cell = m.clip(hi - lo, min=1e-30) * kv / Dv
    p0 = ray.at(mint)
    bidx = block_index_of(scene, meta, medium_idx, p0)
    d = ray.d
    degen = torch.abs(d) < 1e-12
    safe_d = torch.where(degen, torch.where(d >= 0, 1e-12, -1e-12), d)
    face = torch.where(safe_d > 0, (bidx + 1).to(torch.float32),
                       bidx.to(torch.float32)) * cell + lo
    t_next = mint[:, None] + (face - p0) / safe_d
    t_next = torch.where(degen, m.Infinity,
                         torch.maximum(t_next, mint[:, None]))
    t_delta = torch.where(degen, m.Infinity, cell / torch.abs(safe_d))
    return bidx, t_next, t_delta


def get_majorant(scene, medium_idx):
    """Combined extinction bound of each lane's medium (N, 3)."""
    P, _ = _rows(scene, medium_idx)
    return P[:, M_MAJORANT:M_MAJORANT + 3]


def get_scattering_coefficients(scene, meta, medium_idx, p, active,
                                diff: bool = False):
    """(sigma_s, sigma_n, sigma_t) at world point p, per lane;
    sigma_n = majorant - sigma_t."""
    P, mtype = _rows(scene, medium_idx)
    sigma_t = P[:, M_SIGMA_T:M_SIGMA_T + 3] * P[:, M_SCALE:M_SCALE + 1]
    albedo = P[:, M_ALBEDO:M_ALBEDO + 3]
    if MT_HETEROGENEOUS in meta.medium_types and \
            scene.media.grid_sigma_t.numel() > 1:
        dens = _sigma_grid_eval(scene, P[:, M_BBOX_MIN:M_BBOX_MIN + 3],
                                P[:, M_BBOX_MAX:M_BBOX_MAX + 3], p, diff)
        is_het = (mtype == MT_HETEROGENEOUS)[:, None]
        sigma_t = torch.where(is_het, sigma_t * dens[:, None], sigma_t)
    sigma_s = sigma_t * albedo
    sigma_n = m.clip(P[:, M_MAJORANT:M_MAJORANT + 3] - sigma_t,
                          min=0.0)
    z = ~active[:, None]
    return (torch.where(z, 0.0, sigma_s), torch.where(z, 0.0, sigma_n),
            torch.where(z, 0.0, sigma_t))


def sample_interaction(scene, meta, ray: Ray, u, channel, medium_idx,
                       active) -> Tuple[MediumInteraction, torch.Tensor]:
    """Free-flight distance sampling against the majorant of the hero
    ``channel``. Returns (mi, mint); ``mi.valid``: a (real or null)
    collision sampled before the ray leaves the medium. No integrator
    calls it; it is kept for parity with the reference."""
    aabb_hit, mint, maxt = intersect_aabb(scene, meta, medium_idx, ray)
    act = active & aabb_hit
    mint = torch.where(act, torch.maximum(ray.mint, mint), 0.0)
    maxt = torch.where(act, torch.minimum(ray.maxt, maxt), m.Infinity)
    majorant = get_majorant(scene, medium_idx)
    mj = _ch(majorant, channel)
    u = m.clip(u, 0.0, m.OneMinusEpsilon)
    sampled_t = mint + (-torch.log1p(-u) / m.clip(mj, min=1e-30))
    valid = act & (sampled_t <= maxt) & (mj > 0)
    t = torch.where(valid, sampled_t, m.Infinity)
    p = ray.at(torch.where(valid, sampled_t, 0.0))
    sigma_s, sigma_n, sigma_t = get_scattering_coefficients(
        scene, meta, medium_idx, p, valid)
    mi = MediumInteraction(
        valid=valid, t=t, p=p, wi=-ray.d,
        medium_idx=medium_idx, sigma_s=sigma_s, sigma_n=sigma_n,
        sigma_t=sigma_t, combined_extinction=majorant)
    return mi, mint


def eval_tr_and_pdf(mi: MediumInteraction, mint, si_t, active):
    """Transmittance and free-flight pdf of a sampled segment."""
    t = torch.minimum(torch.where(torch.isfinite(mi.t), mi.t, si_t),
                      si_t) - mint
    t = m.clip(t, min=0.0)
    tr = torch.exp(-t[:, None] * mi.combined_extinction)
    pdf = torch.where((si_t < mi.t)[:, None], tr,
                      tr * mi.combined_extinction)
    return tr, pdf


def homogeneous_transmittance(scene, medium_idx, length, active):
    """Closed-form transmittance of a homogeneous segment (the majorant
    equals sigma_t there)."""
    majorant = get_majorant(scene, medium_idx)
    tr = torch.exp(-m.clip(length, min=0.0)[:, None] * majorant)
    return torch.where(active[:, None], tr, 1.0)


def is_homogeneous_like(scene, meta, medium_idx):
    """Lanes whose medium has a constant extinction: homogeneous, or
    nonlinear (optically homogeneous)."""
    _, mtype = _rows(scene, medium_idx)
    return (mtype == MEDIUM_TYPES['homogeneous']) \
        | (mtype == MEDIUM_TYPES['nonlinear'])


def _medium_facts(scene, medium_idx):
    """Loop-invariant facts of each lane's medium for the walks:
    (sigma_t * scale per unit density (N, 3), albedo (N, 3), lo (N, 3),
    hi (N, 3), is_het (N,))."""
    P, mtype = _rows(scene, medium_idx)
    sigma_unit = P[:, M_SIGMA_T:M_SIGMA_T + 3] * P[:, M_SCALE:M_SCALE + 1]
    return (sigma_unit, P[:, M_ALBEDO:M_ALBEDO + 3],
            P[:, M_BBOX_MIN:M_BBOX_MIN + 3], P[:, M_BBOX_MAX:M_BBOX_MAX + 3],
            mtype == MT_HETEROGENEOUS)


def _row_eval(scene, meta, medium_idx, lo, hi, p, diff: bool = False):
    """(density, block bound, block control, usable) at world point p in
    one row gather of the corner-packed grid (slot 8 the block's bound,
    slot 9 its control or leap distance); without the packed copy, or
    under ``diff``, a trilinear lookup of ``grid_sigma_t`` and a gather of
    the point's supervoxel. All are 0 outside the grid bbox; ``usable`` is
    False where the scene has no block bounds (the walk then uses the
    global majorant)."""
    med = scene.media
    if med.grid_sigma_p8 is not None and not diff:
        inside, rows, w = _packed_row(med.grid_sigma_p8,
                                      med.grid_sigma_t.shape, lo, hi, p)
        dens = (rows[..., :8] * w).sum(dim=-1)
        return (torch.where(inside, dens, 0.0),
                torch.where(inside, rows[..., 8], 0.0),
                torch.where(inside, rows[..., 9], 0.0), True)
    dens = _sigma_grid_eval(scene, lo, hi, p, diff)
    sup, smin = med.grid_sup, med.grid_sup_min
    if sup.numel() > 1 or med.grid_sigma_t.numel() > 1:
        rel = (p - lo) / m.clip(hi - lo, min=1e-30)
        inside = ((rel >= 0.0) & (rel <= 1.0)).all(dim=-1)
        if sup.numel() > 1:
            Sz, Sy, Sx = sup.shape
            bidx = block_index_of(scene, meta, medium_idx, p).long()
            bz = m.clip(bidx[:, 2], 0, Sz - 1)
            by = m.clip(bidx[:, 1], 0, Sy - 1)
            bx = m.clip(bidx[:, 0], 0, Sx - 1)
            bmaj = sup[bz, by, bx]
            bmin = (smin[bz, by, bx] if smin.shape == sup.shape
                    else torch.zeros(p.shape[:-1], device=p.device))
        else:
            # a one-block supervoxel grid (tiny density grids)
            bmaj = sup.reshape(-1)[0].expand(p.shape[:-1])
            bmin = (smin.reshape(-1)[0].expand(p.shape[:-1])
                    if smin.numel() == 1
                    else torch.zeros(p.shape[:-1], device=p.device))
        return (dens, torch.where(inside, bmaj, 0.0),
                torch.where(inside, bmin, 0.0), True)
    z = torch.zeros(p.shape[:-1], device=p.device)
    return dens, z, z, False


class _Walk(NamedTuple):
    """Carried state of the majorant walk, one row a lane."""
    t: torch.Tensor           # (N,) current distance along the ray
    w: torch.Tensor           # (N, 3) carried weight
    walking: torch.Tensor     # (N,) bool
    found: torch.Tensor       # (N,) bool, a real collision (track=True)
    maj_vec: torch.Tensor     # (N, 3) the current block's majorant
    c_vec: torch.Tensor       # (N, 3) the current block's control
    d_leap: torch.Tensor      # (N,) leap distance of a vacuum block
    dens_col: torch.Tensor    # (N,) density at the real collision
    t_next_ax: torch.Tensor   # (N, 3) next block crossing per axis
    t_ctrl: torch.Tensor      # (N,) pending control collision (track=True)


def _majorant_walk(scene, meta, ray: Ray, key, channel, medium_idx,
                   mint, maxt, walking, track: bool, max_steps: int,
                   diff: bool = False, lanes=None):
    """Null-collision walk over [mint, maxt] against supervoxel-local
    majorants, with one row gather a tracking event: at the collision
    point (collision events) or at the midpoint of the next DDA interval
    (crossing events), which addresses the new block exactly.

    track=False (transmittance, ratio tracking): every collision is null,
    w *= sigma_n / rate, with Russian roulette on the carried weight.
    track=True (delta tracking to the next real collision, with
    decomposition tracking): each block's constant control
    c = sigma_unit * block_min is drawn analytically and is always real;
    the loop iterates residual events at rate mj_loc - c, and a residual
    event is real with probability (sigma_t - c) / (mj_loc - c). Marginal
    over event type, the weights are plain delta tracking's at rate
    mj_loc: null w *= sigma_n * mj_loc / sigma_n_hero, collision step
    w *= exp(-dt * (maj - mj_loc)) / mj_loc (hero-channel telescoping;
    the caller applies the real event's sigma_s factor).

    Under ``diff`` the walk runs at most ``ceil(min(max_steps, 192) /
    WALK_UNROLL)`` trips, each checkpointed (the reference's scan).

    ``lanes``: the sampler's places in a global wavefront
    (``rng.Lanes``), where it draws for a shard of one.

    Returns (t, w, found, dens_col, maj_vec, still_walking, events)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    channel = channel.long()
    sigma_unit, _, lo, hi, is_het = _medium_facts(scene, medium_idx)
    majorant = get_majorant(scene, medium_idx)
    _, t_next0, t_delta = _dda_init(scene, meta, medium_idx, ray, mint)
    has_sup = _has_supervoxels(scene, meta)
    t_delta_fin = torch.where(torch.isfinite(t_delta), t_delta, 0.0)

    def local_bounds(bmaj_b, bmin_b, bok):
        """(majorant, control, leap distance) of the current block; the
        global majorant with no control where there are no block bounds.
        A negative block min is a vacuum block's leap distance."""
        if not bok:
            return majorant, torch.zeros_like(majorant), \
                torch.zeros_like(bmaj_b)
        mv = torch.where(is_het[:, None], sigma_unit * bmaj_b[:, None],
                         majorant)
        bmin_pos = m.clip(bmin_b, min=0.0)
        cv = torch.where(is_het[:, None],
                         sigma_unit * torch.minimum(bmin_pos,
                                                    bmaj_b)[:, None], 0.0)
        Dd = torch.where(is_het, m.clip(-bmin_b, min=0.0), 0.0)
        return mv, cv, Dd

    def ctrl_draw(t_from, c_vec, u):
        """Distance of the next control collision (inf without control)."""
        c_h = _ch(c_vec, channel)
        t_c = t_from - torch.log1p(-m.clip(u, 0.0, m.OneMinusEpsilon)) \
            / m.clip(c_h, min=1e-30)
        return torch.where(c_h > 1e-20, t_c, m.Infinity)

    def sub_step(s: _Walk, u) -> _Walk:
        """One tracking event (residual collision, control collision or
        block crossing) for every walking lane, fully masked."""
        t, w, walking = s.t, s.w, s.walking
        mj_loc = _ch(s.maj_vec, channel)
        c_loc = _ch(s.c_vec, channel)
        # the loop's event rate is the residual maj - c in both modes
        res_rate = m.clip(mj_loc - c_loc, min=0.0)
        r_pos = res_rate > 1e-20
        dt = -torch.log1p(-m.clip(u[:, 0], 0.0, m.OneMinusEpsilon)) \
            / torch.where(r_pos, res_rate, 1.0)
        dt = torch.where(r_pos, dt, 3e38)
        t_exit = s.t_next_ax.amin(dim=-1)
        t_stop = torch.minimum(t_exit, maxt)
        if track:
            t_res = t + dt
            ctrl_hit = walking & (s.t_ctrl <= t_res) & (s.t_ctrl <= t_stop)
            boundary = walking & ~ctrl_hit & (t_res > t_stop)
            col = walking & ~boundary
            t_new = torch.where(ctrl_hit, s.t_ctrl, torch.where(
                col, t_res, torch.where(boundary, t_stop, t)))
            rate = torch.where(mj_loc > 1e-20, mj_loc, 0.0)
        else:
            ctrl_hit = None
            boundary = walking & (t + dt > t_stop)
            col = walking & ~boundary
            t_new = torch.where(col, t + dt,
                                torch.where(boundary, t_stop, t))
            rate = torch.where(r_pos, res_rate, 0.0)
        # hero-channel telescoped exponential over the step
        seg = m.clip(torch.where(col, t_new - t, t_stop - t), min=0.0)
        ratio = torch.exp(-seg[:, None] * (s.maj_vec - rate[:, None]))
        if track:
            w = torch.where(walking[:, None], w * ratio / torch.where(
                col, m.clip(rate, min=1e-30), 1.0)[:, None], w)
        else:
            w = torch.where(walking[:, None], w * ratio, w)
        # DDA step for block crossings
        crossed = boundary & ~(t_stop >= maxt)
        step_ax = crossed[:, None] & (s.t_next_ax <= t_exit[:, None])
        t_next_new = s.t_next_ax + torch.where(step_ax, t_delta, 0.0)
        if has_sup:
            # empty-space leap: every block before min_axis(t_next +
            # (d_leap - 1) * t_delta) is vacuum, so jump there at once;
            # the per-axis crossings stay on their lattice
            t_shift = m.clip(s.d_leap - 1.0, min=0.0)[:, None] \
                * t_delta_fin
            leap = crossed & (s.d_leap >= 1.0)
            t_safe = (s.t_next_ax + t_shift).amin(dim=-1)
            esc_leap = leap & (t_safe >= maxt)
            crossed = crossed & ~esc_leap
            leap = leap & ~esc_leap
            t_new = torch.where(leap, torch.minimum(t_safe, maxt), t_new)
            behind = (s.t_next_ax <= t_safe[:, None]) \
                & torch.isfinite(t_delta)
            n_a = torch.floor(
                m.clip(t_safe[:, None] - s.t_next_ax, min=0.0)
                / torch.where(behind, t_delta, 1.0)) + 1.0
            tn_l = torch.where(behind, s.t_next_ax + n_a * t_delta,
                               s.t_next_ax)
            t_next_new = torch.where(leap[:, None], tn_l, t_next_new)
        # the one gather: the collision point, or the next interval's
        # midpoint
        t_exit_new = t_next_new.amin(dim=-1)
        probe_t = torch.where(
            col, t_new, 0.5 * (t_new + torch.minimum(t_exit_new, maxt)))
        dens, bmaj, bmin, bok = _row_eval(
            scene, meta, medium_idx, lo, hi,
            ray.at(torch.where(walking, probe_t, 0.0)), diff)
        sigma_t_v = torch.where(is_het[:, None], sigma_unit * dens[:, None],
                                sigma_unit)
        sigma_n_loc = m.clip(s.maj_vec - sigma_t_v, min=0.0)
        found, dens_col = s.found, s.dens_col
        if track:
            st_ch = _ch(sigma_t_v, channel)
            sn_ch = _ch(sigma_n_loc, channel)
            p_real = m.clip(st_ch - c_loc, min=0.0) \
                / m.clip(res_rate, min=1e-30)
            real = ctrl_hit | (col & (u[:, 1] < p_real))
            null = col & ~real
            w = torch.where(null[:, None], w * sigma_n_loc
                            * m.safe_div(rate, sn_ch)[:, None], w)
            found = found | real
            dens_col = torch.where(real, dens, dens_col)
            walking_next = null | crossed
        else:
            w = torch.where(col[:, None], w * sigma_n_loc * m.safe_rcp(
                m.clip(rate, min=1e-30))[:, None], w)
            wmax = w.amax(dim=-1)
            rr = col & (wmax < RR_TR_THRESH)
            p_srv = m.clip(wmax * (1.0 / RR_TR_THRESH), 0.0, 1.0)
            die = rr & (u[:, 1] >= p_srv)
            w = torch.where((rr & ~die)[:, None], w * m.safe_rcp(
                m.clip(p_srv, min=1e-30))[:, None], w)
            w = torch.where(die[:, None], 0.0, w)
            walking_next = (col & ~die) | crossed
        # crossing lanes adopt the new block's bounds (midpoint probe);
        # collision lanes keep theirs
        maj_new, c_new, d_new = local_bounds(bmaj, bmin, bok)
        het_cross = crossed & is_het
        maj_vec = torch.where(het_cross[:, None], maj_new, s.maj_vec)
        c_vec = torch.where(het_cross[:, None], c_new, s.c_vec)
        d_leap = torch.where(het_cross, d_new, s.d_leap)
        t_ctrl = s.t_ctrl
        if track:
            # crossed lanes redraw the pending control collision from the
            # new block's control (null lanes keep theirs: memoryless)
            t_ctrl = torch.where(crossed, ctrl_draw(t_new, c_vec, u[:, 2]),
                                 t_ctrl)
        return _Walk(t_new, w, walking_next, found, maj_vec, c_vec, d_leap,
                     dens_col, t_next_new, t_ctrl)

    # the initial interval [mint, min(exit, maxt)]: probe its midpoint
    mid0 = 0.5 * (mint + torch.minimum(t_next0.amin(dim=-1), maxt))
    _, bmaj0, bmin0, bok0 = _row_eval(scene, meta, medium_idx, lo, hi,
                                      ray.at(mid0), diff)
    maj_vec0, c_vec0, d_leap0 = local_bounds(bmaj0, bmin0, bok0)
    t0 = torch.where(walking, mint, 0.0)
    if track:
        t_ctrl0 = ctrl_draw(t0, c_vec0, rng.uniform(
            rng.fold_in(key, _CTRL0_FOLD), (N,), dev, scene.dtype,
            lanes=lanes))
    else:
        t_ctrl0 = torch.full((N,), m.Infinity, device=dev)
    s = _Walk(t0, torch.ones((N, 3), device=dev), walking,
              torch.zeros((N,), dtype=torch.bool, device=dev), maj_vec0,
              c_vec0, d_leap0, torch.zeros((N,), device=dev), t_next0,
              t_ctrl0)
    n_u = 3 if track else 2

    def trip(s: _Walk, it: int) -> _Walk:
        us = rng.uniform(rng.fold_in(key, it), (WALK_UNROLL, N, n_u), dev,
                         scene.dtype, lanes=lanes, axis=1)
        for k in range(WALK_UNROLL):
            s = sub_step(s, us[k])
        return s

    # the reference's while_loop: WALK_UNROLL masked events a trip, at
    # most max_steps events, one read of any(walking) a trip. Under diff
    # its scan of ceil(min(max_steps, 192) / WALK_UNROLL) checkpointed
    # trips; a trip with no lane walking changes nothing, so the loop
    # stops there all the same.
    cap = max_steps
    if diff:
        cap = -(-min(max_steps, DIFF_WALK_EVENTS) // WALK_UNROLL) \
            * WALK_UNROLL
    it = 0
    while it < cap and any_on_host(s.walking):
        s = remat.checkpoint(trip, s, it) if diff else trip(s, it)
        it += WALK_UNROLL
    return s.t, s.w, s.found, s.dens_col, s.maj_vec, s.walking, it


def segment_tr(scene, meta, sampler, o, d, seg_len, medium_idx, channel,
               active, diff: bool = False):
    """Spectral transmittance over one medium segment [0, seg_len] along
    (o, d): exact Beer-Lambert for homogeneous media, supervoxel ratio
    tracking for heterogeneous ones. Returns (tr (N, 3), sampler)."""
    N = o.shape[0]
    dev = o.device
    majorant = get_majorant(scene, medium_idx)
    seg = m.clip(torch.where(torch.isfinite(seg_len), seg_len, 0.0),
                      min=0.0)
    tr_homo = torch.exp(-majorant * seg[:, None])
    if MT_HETEROGENEOUS not in meta.medium_types:
        return torch.where(active[:, None], tr_homo, 1.0), sampler

    midx = m.clip(medium_idx, min=0).long()
    is_het = (scene.media.type[midx] == MT_HETEROGENEOUS) & active
    key = rng.fold_in(sampler.key, sampler.dim)
    sampler = sampler._replace(dim=sampler.dim + 1)
    ray = Ray(o, d, torch.zeros((N,), device=dev),
              torch.full((N,), m.Infinity, device=dev))
    # clip to the grid bbox: the density is zero outside, and the walk's
    # midpoint probes must land inside it
    hit_bb, near, far = intersect_aabb(scene, meta, medium_idx, ray)
    mint = torch.minimum(m.clip(near, min=0.0), seg)
    maxt = torch.minimum(m.clip(far, min=0.0), seg)
    walking = is_het & hit_bb & (maxt > mint)
    _, tr_het, _, _, _, still, _ = _majorant_walk(
        scene, meta, ray, key, channel, medium_idx, mint, maxt, walking,
        track=False, max_steps=1024, diff=diff, lanes=sampler.at)
    tr_het = torch.where(still[:, None], 0.0, tr_het)   # hit the cap
    tr = torch.where(is_het[:, None], tr_het, tr_homo)
    return torch.where(active[:, None], tr, 1.0), sampler


def sample_real_interaction(scene, meta, ray: Ray, sampler, channel,
                            medium_idx, active, max_steps: int = 4096,
                            diff: bool = False):
    """Delta tracking to the next real collision, null collisions resolved
    inside the walk. The weights equal the reference's outer-loop form
    (one majorant event a bounce), so the estimator is unchanged:

      collision step:  w *= exp(-dt*maj) / (exp(-dt*maj_ch) * maj_ch)
      null event:      w *= sigma_n * maj_ch / sigma_n_ch
      escape:          w *= exp(-dt*maj) / exp(-dt*maj_ch)

    Returns (mi, weight (N, 3), sampler). ``mi.valid``: a real collision
    before ``ray.maxt``; otherwise the lane left the segment and
    ``weight`` is the ratio-tracked Tr / pdf of escaping. The real
    event's factor sigma_s * maj_ch / sigma_t_ch is the caller's."""
    aabb_hit, mint, maxt = intersect_aabb(scene, meta, medium_idx, ray)
    act = active & aabb_hit
    mint = torch.where(act, torch.maximum(ray.mint, mint), 0.0)
    maxt = torch.where(act, torch.minimum(ray.maxt, maxt), 0.0)
    majorant = get_majorant(scene, medium_idx)
    mj_glob = _ch(majorant, channel)
    walking = act & (mj_glob > 1e-30) & (maxt > mint)
    key = rng.fold_in(sampler.key, sampler.dim)
    sampler = sampler._replace(dim=sampler.dim + 1)

    t, w, found, dens_col, maj_col, _, _ = _majorant_walk(
        scene, meta, ray, key, channel, medium_idx, mint, maxt, walking,
        track=True, max_steps=max_steps, diff=diff, lanes=sampler.at)

    # lanes whose hero majorant is zero never walk: they leave the segment
    # with the exact Beer-Lambert ratio of the other channels; the finite
    # clamp keeps inf * 0 out of gray media
    never = act & ~walking
    seg_n = m.clip(m.clip(maxt - mint, min=0.0), max=3e37)
    w = torch.where(never[:, None], torch.exp(
        -seg_n[:, None] * (majorant - mj_glob[:, None])), w)

    # sigma at the real collision, from the walk's carried density
    sigma_unit, albedo, _, _, is_het = _medium_facts(scene, medium_idx)
    sigma_t = torch.where(is_het[:, None], sigma_unit * dens_col[:, None],
                          sigma_unit)
    z = ~found[:, None]
    sigma_t = torch.where(z, 0.0, sigma_t)
    mi = MediumInteraction(
        valid=found, t=torch.where(found, t, m.Infinity),
        p=ray.at(torch.where(found, t, 0.0)), wi=-ray.d,
        medium_idx=medium_idx,
        sigma_s=torch.where(z, 0.0, sigma_t * albedo),
        sigma_n=torch.where(z, 0.0, m.clip(maj_col - sigma_t,
                                                min=0.0)),
        sigma_t=sigma_t,
        combined_extinction=torch.where(found[:, None], maj_col, majorant))
    return mi, torch.where(act[:, None], w, 1.0), sampler

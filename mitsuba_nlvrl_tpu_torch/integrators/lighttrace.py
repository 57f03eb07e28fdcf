"""Wavefront light tracing: photon and VRL shooting.

Port of ``mitsuba_nlvrl_tpu/integrators/lighttrace.py``. A wavefront of
light paths marches in lock-step through the bounce iterations; every
iteration appends its deposits (surface photons, volume photons, VRL
segments) to fixed-capacity reservoirs. Nonlinear media bend the rays
between collisions with an inner cell march that deposits a VRL at every
direction change.

Deposit rules, as the reference's:
  * surface photons at smooth BSDFs; caustic if the previous non-null
    bounce was a transmission, else global;
  * volume photons at the first scatter of a medium chain (every scatter
    for the photon mapper);
  * VRLs end at real scatters, surfaces and bends, carrying flux times
    throughput at the segment start;
  * each map is scaled by 1 / the number of paths shot.

The reference's ``lax.scan`` loops (the bounces, max_depth + 2 of them,
and the bends, max_bends a bounce) become host loops that stop once no
lane is alive (one read of ``any`` a trip, ``core/sync.py``). That changes
nothing: a skipped trip would draw random numbers no lane uses and deposit
nothing, and the rows of the skipped bends are invalid, so the valid rows
keep their order in the reservoirs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import math as m
from ..core import rng
from ..core.ray import Ray
from ..core.rng import Sampler
from ..core.sync import any_on_host
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from .. import medium as medium_mod
from .. import phase as phase_mod
from ..medium import nonlinear as nl_mod
from ..ops import hashgrid
from ..ops import intersect as isect
from ..scene.types import F_SMOOTH, F_TRANSMISSION, MEDIUM_TYPES


class RawDeposits(NamedTuple):
    """Fixed-capacity deposit reservoirs filled as the bounces run."""
    sp_pos: torch.Tensor      # (P, 3)
    sp_power: torch.Tensor
    sp_dir: torch.Tensor
    sp_normal: torch.Tensor
    sp_depth: torch.Tensor
    sp_caustic: torch.Tensor
    sp_count: torch.Tensor    # () int32 rows filled
    vp_pos: torch.Tensor      # (Q, 3)
    vp_power: torch.Tensor
    vp_dir: torch.Tensor
    vp_depth: torch.Tensor
    vp_count: torch.Tensor
    vrl_o: torch.Tensor       # (V, 3)
    vrl_e: torch.Tensor       # (V, 3)
    vrl_flux: torch.Tensor
    vrl_medium: torch.Tensor
    vrl_depth: torch.Tensor
    vrl_direct: torch.Tensor
    vrl_count: torch.Tensor
    # per-path "deposited at least once" flags and loss counts
    sp_contrib: torch.Tensor  # (N,) bool
    vp_contrib: torch.Tensor
    vrl_contrib: torch.Tensor
    sp_lost: torch.Tensor     # () int32 deposits dropped at capacity
    vp_lost: torch.Tensor
    vrl_lost: torch.Tensor
    trunc_paths: torch.Tensor  # () int32 paths alive at the depth cap


def _scatter_rows(bufs, count, valid, rows, cap: int):
    """Append ``rows[valid]`` to the reservoir ``bufs`` (each with one
    spare row past ``cap`` that takes the dropped rows) at ``count``.
    Returns (new_bufs, new_count, n_lost); no host read."""
    idx = count + torch.cumsum(valid.to(torch.int32), 0) - 1
    ok = valid & (idx < cap)
    iw = torch.where(ok, idx, cap).long()
    new = [b.index_put((iw,), r) for b, r in zip(bufs, rows)]
    n_valid = valid.sum(dtype=torch.int32)
    new_count = m.clip(count + n_valid, max=cap)
    return new, new_count, count + n_valid - new_count


class PhotonMaps(NamedTuple):
    # surface photons
    sp_pos: torch.Tensor      # (P, 3)
    sp_power: torch.Tensor    # (P, 3)
    sp_dir: torch.Tensor      # (P, 3) propagation direction at deposit
    sp_normal: torch.Tensor   # (P, 3)
    sp_depth: torch.Tensor    # (P,)
    sp_caustic: torch.Tensor  # (P,) bool
    sp_valid: torch.Tensor    # (P,) bool
    global_grid: hashgrid.HashGrid
    caustic_grid: hashgrid.HashGrid
    sp_scale: torch.Tensor    # ()
    # volume photons
    vp_pos: torch.Tensor
    vp_power: torch.Tensor
    vp_dir: torch.Tensor
    vp_depth: torch.Tensor
    vp_valid: torch.Tensor
    vp_grid: hashgrid.HashGrid
    vp_scale: torch.Tensor
    # VRLs
    vrl_o: torch.Tensor       # (V, 3)
    vrl_d: torch.Tensor       # (V, 3) unit
    vrl_len: torch.Tensor     # (V,)
    vrl_flux: torch.Tensor    # (V, 3)
    vrl_medium: torch.Tensor  # (V,) int32
    vrl_depth: torch.Tensor   # (V,)
    vrl_direct: torch.Tensor  # (V,) bool
    vrl_valid: torch.Tensor   # (V,) bool
    vrl_scale: torch.Tensor   # ()
    vrl_count: torch.Tensor   # () int32 valid (compacted) VRLs
    # deposits dropped at capacity and paths cut at the light-depth cap
    sp_lost: torch.Tensor
    vp_lost: torch.Tensor
    vrl_lost: torch.Tensor
    trunc_paths: torch.Tensor
    # packed rows, one gather a record:
    # vrl_packed [o(3) d(3) len flux(3) medium valid],
    # sp_packed [pos(3) dir(3) power(3) caustic valid pad],
    # vp_packed [pos(3) dir(3) power(3) radius valid pad]
    vrl_packed: torch.Tensor
    sp_packed: torch.Tensor
    vp_packed: torch.Tensor
    # per-photon radius from the local density (build_maps)
    vp_radius: torch.Tensor
    # the VRL clusters (vrl.VRLClusters); None without the cluster strategy
    clusters: Optional[object] = None


class ShootState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor
    flux: torch.Tensor
    eta: torch.Tensor
    depth: torch.Tensor
    medium_depth: torch.Tensor
    was_transmitted: torch.Tensor
    is_direct: torch.Tensor
    medium_idx: torch.Tensor
    active: torch.Tensor
    vrl_start: torch.Tensor      # (N, 3) current VRL segment origin
    vrl_flux: torch.Tensor       # (N, 3) flux * throughput at its start
    vrl_medium: torch.Tensor
    vrl_depth: torch.Tensor
    vrl_direct: torch.Tensor
    channel: torch.Tensor


def _march_nonlinear(scene, meta, st: ShootState, t_coll, active_nl,
                     max_bends: int, min_vrl_len):
    """Walk the sampled free-flight distance along a bending ray, emitting
    a VRL deposit at every direction change. Returns (ray, remaining
    distance, VRL start, deposits), the deposits a list of (N, ...)
    tuples, one a bend trip taken."""
    ray, remaining = st.ray, t_coll
    vrl_start, act = st.vrl_start, active_nl
    deps = []
    for _ in range(max_bends):
        if not any_on_host(act):
            break
        nli = nl_mod.sample_nonlinear_interaction(scene, meta, ray,
                                                  st.medium_idx, act)
        # a surface before the bend point cancels it: one any hit
        blocked = isect.ray_test(scene, Ray(ray.o, ray.d, ray.mint,
                                            torch.minimum(remaining, nli.t)))
        bend = act & nli.valid & (nli.t < remaining) & ~blocked
        changed = bend & (m.dot(nli.wo, ray.d) < 1.0 - 1e-7)
        seg_len = m.norm(nli.p - vrl_start)
        dep_ok = changed & (seg_len > min_vrl_len) & (st.medium_idx >= 0)
        deps.append((vrl_start, nli.p, st.vrl_flux, st.medium_idx, st.depth,
                     st.is_direct, dep_ok))
        vrl_start = torch.where(changed[:, None], nli.p, vrl_start)
        # lanes that did not bend keep their mint (an area-emitter ray
        # starts an epsilon off its luminaire)
        ray = Ray(o=torch.where(bend[:, None], nli.p, ray.o),
                  d=torch.where(bend[:, None], nli.wo, ray.d),
                  mint=torch.where(bend, 0.0, ray.mint), maxt=ray.maxt)
        remaining = torch.where(bend, remaining - nli.t, remaining)
        act = bend
    return ray, remaining, vrl_start, deps


# the reservoirs' row arrays (one spare row each while shooting)
_RESERVOIRS = ('sp_pos', 'sp_power', 'sp_dir', 'sp_normal', 'sp_depth',
               'sp_caustic', 'vp_pos', 'vp_power', 'vp_dir', 'vp_depth',
               'vrl_o', 'vrl_e', 'vrl_flux', 'vrl_medium', 'vrl_depth',
               'vrl_direct')


def _empty_raw(N, sp_cap, vp_cap, vrl_cap, dev,
               ft=torch.float32) -> RawDeposits:
    """Reservoirs with one spare row each (``_scatter_rows``), their
    floats in the scene's type ``ft``."""
    def z(n, *shape, dtype=ft):
        return torch.zeros((n + 1,) + shape, dtype=dtype, device=dev)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    zb = torch.zeros((N,), dtype=torch.bool, device=dev)
    i32, b = torch.int32, torch.bool
    return RawDeposits(
        sp_pos=z(sp_cap, 3), sp_power=z(sp_cap, 3), sp_dir=z(sp_cap, 3),
        sp_normal=z(sp_cap, 3), sp_depth=z(sp_cap, dtype=i32),
        sp_caustic=z(sp_cap, dtype=b), sp_count=zi,
        vp_pos=z(vp_cap, 3), vp_power=z(vp_cap, 3), vp_dir=z(vp_cap, 3),
        vp_depth=z(vp_cap, dtype=i32), vp_count=zi,
        vrl_o=z(vrl_cap, 3), vrl_e=z(vrl_cap, 3), vrl_flux=z(vrl_cap, 3),
        vrl_medium=torch.full((vrl_cap + 1,), -1, dtype=i32, device=dev),
        vrl_depth=z(vrl_cap, dtype=i32), vrl_direct=z(vrl_cap, dtype=b),
        vrl_count=zi, sp_contrib=zb, vp_contrib=zb, vrl_contrib=zb,
        sp_lost=zi, vp_lost=zi, vrl_lost=zi, trunc_paths=zi)


def shoot(scene, meta, key, n_paths: int, max_depth: int = 8,
          rr_depth: int = 5, max_bends: int = 0, min_vrl_len: float = 0.0,
          vp_all_scatters: bool = False, sp_cap: int = 262144,
          vp_cap: int = 262144, vrl_cap: int = 8192) -> RawDeposits:
    """Trace ``n_paths`` light paths for at most max_depth + 2 bounce
    iterations, appending their deposits to the reservoirs."""
    N = n_paths
    dev = scene.device
    sampler = Sampler.make(key, N, dev)
    u_sel, sampler = sampler.next_1d()
    u_pos, sampler = sampler.next_2d()
    u_dir, sampler = sampler.next_2d()
    act0 = torch.ones((N,), dtype=torch.bool, device=dev)
    ray, flux, _, _ = emitter_mod.sample_ray(scene, meta, u_sel, u_pos,
                                             u_dir, act0)
    if meta.iprop('use_laser', False):
        # the laser replaces the ray's geometry only: the flux stays the
        # sampled emitter's, as the reference keeps it
        lo = torch.tensor(meta.iprop('laser_origin', (0.0, 0.0, 0.0)),
                          dtype=scene.dtype, device=dev)
        ld = m.normalize(torch.tensor(
            meta.iprop('laser_direction', (0.0, 0.0, 1.0)),
            dtype=scene.dtype, device=dev))
        ray = Ray.make(lo.expand(N, 3).contiguous(),
                       ld.expand(N, 3).contiguous(), mint=0.0)

    u_ch, sampler = sampler.next_1d()
    channel = m.clip((u_ch * 3).to(torch.int32), max=2)

    i32 = torch.int32
    st = ShootState(
        sampler=sampler, ray=ray, throughput=torch.ones((N, 3), device=dev),
        flux=flux, eta=torch.ones((N,), device=dev),
        depth=torch.ones((N,), dtype=i32, device=dev),
        medium_depth=torch.zeros((N,), dtype=i32, device=dev),
        was_transmitted=torch.zeros((N,), dtype=torch.bool, device=dev),
        is_direct=act0, medium_idx=torch.full((N,), -1, dtype=i32,
                                              device=dev),
        active=act0, vrl_start=ray.o, vrl_flux=flux,
        vrl_medium=torch.full((N,), -1, dtype=i32, device=dev),
        vrl_depth=torch.ones((N,), dtype=i32, device=dev),
        vrl_direct=act0, channel=channel)

    has_nl = MEDIUM_TYPES['nonlinear'] in meta.medium_types and max_bends > 0
    raw = _empty_raw(N, sp_cap, vp_cap, vrl_cap, dev, scene.dtype)
    trunc = torch.zeros((N,), dtype=torch.bool, device=dev)
    inf = torch.full((N,), m.Infinity, device=dev)

    it = 0
    while it < max_depth + 2 and any_on_host(st.active):
        it += 1
        smp = st.sampler
        throughput = st.throughput

        # russian roulette
        active = st.active & (throughput != 0).any(dim=-1)
        q = m.clip((throughput.amax(dim=-1) * m.sqr(st.eta)).detach(),
                        max=0.95)
        perform_rr = st.depth > rr_depth
        u_rr, smp = smp.next_1d()
        active = active & ((u_rr < q) | ~perform_rr)
        throughput = torch.where(perform_rr[:, None],
                                 throughput * m.safe_rcp(q)[:, None],
                                 throughput)
        # a path stopped by the depth cap (not by RR or absorption) is
        # truncated energy: flag it for the map statistics
        trunc = trunc | (active & (st.depth >= max_depth))
        active = active & (st.depth < max_depth)

        active_medium = active & (st.medium_idx >= 0)
        active_surface = active & ~active_medium

        # --- nonlinear bending: the medium is optically homogeneous, so
        # an analytic free flight against its majorant is exact ----------
        u_fl, smp = smp.next_1d()
        cur_ray = st.ray
        vrl_start = st.vrl_start
        bend_deps = []
        if has_nl:
            majorant = medium_mod.get_majorant(scene, st.medium_idx)
            mj = medium_mod._ch(majorant, st.channel)
            midx_safe = m.clip(st.medium_idx, min=0).long()
            is_nl = active_medium & (scene.media.type[midx_safe]
                                     == MEDIUM_TYPES['nonlinear'])
            t_coll = -torch.log1p(-m.clip(u_fl, 0, m.OneMinusEpsilon)) \
                / m.clip(mj, min=1e-30)
            cur_ray, t_coll, vrl_start, bend_deps = _march_nonlinear(
                scene, meta, st._replace(ray=cur_ray), t_coll, is_nl,
                max_bends, min_vrl_len)
        else:
            is_nl = torch.zeros((N,), dtype=torch.bool, device=dev)

        # scene hit along the (possibly bent) ray
        si = isect.ray_intersect(scene, Ray(cur_ray.o, cur_ray.d,
                                            cur_ray.mint, inf))

        # --- delta tracking (homogeneous and heterogeneous lanes) --------
        act_med_std = active_medium & ~is_nl
        mray = Ray(cur_ray.o, cur_ray.d, cur_ray.mint,
                   torch.where(si.valid, si.t, m.Infinity))
        mi, w_med, smp = medium_mod.sample_real_interaction(
            scene, meta, mray, smp, st.channel, st.medium_idx, act_med_std)
        throughput = torch.where(act_med_std[:, None], throughput * w_med,
                                 throughput)
        coll_std = act_med_std & mi.valid

        # --- nonlinear lanes: homogeneous free flight along the bent ray -
        if has_nl:
            coll_nl = is_nl & (mj > 0) & (t_coll < si.t)
            seg_t = torch.minimum(t_coll, si.t)
            seg_t = torch.where(torch.isfinite(seg_t), seg_t, 0.0)
            tr_vec = torch.exp(-seg_t[:, None] * majorant)
            tr_ch = medium_mod._ch(tr_vec, st.channel)
            tr_pdf = torch.where(coll_nl, tr_ch * mj, tr_ch)
            throughput = torch.where(
                is_nl[:, None],
                throughput * torch.where(
                    (tr_pdf > 0)[:, None],
                    tr_vec / m.clip(tr_pdf, min=1e-30)[:, None], 0.0),
                throughput)
        else:
            coll_nl = torch.zeros((N,), dtype=torch.bool, device=dev)

        coll_any = coll_std | coll_nl
        p_coll = mi.p
        if has_nl:
            p_coll = torch.where(
                coll_nl[:, None],
                cur_ray.at(torch.where(coll_nl, t_coll, 0.0)), p_coll)
        sigma_s, _, sigma_t = medium_mod.get_scattering_coefficients(
            scene, meta, st.medium_idx, p_coll, coll_any)
        escaped_medium = active_medium & ~coll_any

        act_real = coll_any
        depth = torch.where(act_real, st.depth + 1, st.depth)
        trunc = trunc | (active & (depth >= max_depth + 1))
        active = active & (depth < max_depth + 1)
        act_real = act_real & active

        # the real-collision factor against the majorant the distance was
        # sampled with (the local one of delta tracking, the global bound
        # of nonlinear lanes)
        comb = mi.combined_extinction
        if has_nl:
            comb = torch.where(coll_nl[:, None], majorant, comb)
        throughput = torch.where(
            act_real[:, None],
            throughput * sigma_s * (
                medium_mod._ch(comb, st.channel) / m.clip(
                    medium_mod._ch(sigma_t, st.channel),
                    min=1e-30))[:, None], throughput)

        # volume photon: the first scatter of a chain, or every scatter
        vp_ok = act_real if vp_all_scatters else \
            (act_real & (st.medium_depth == 0))
        vp_power = st.flux * throughput
        medium_depth = torch.where(act_real, st.medium_depth + 1,
                                   st.medium_depth)
        vrl_end_med_ok = act_real & (st.medium_idx >= 0)

        u2p, smp = smp.next_2d()
        wo_med, _ = phase_mod.sample(scene, meta, st.medium_idx, -cur_ray.d,
                                     u2p, act_real)

        # --- surface leg -------------------------------------------------
        active_surface = (active_surface | escaped_medium) & si.valid
        # paths end at emitter hits
        hit_emitter = active_surface & (si.emitter_idx >= 0)
        active_surface = active_surface & ~hit_emitter
        vrl_end_surf_ok = active_surface & (st.medium_idx >= 0)

        flags = bsdf_mod.flags_of(scene, si)
        sp_ok = active_surface & ((flags & F_SMOOTH) > 0)
        sp_power = st.flux * throughput

        u1b, smp = smp.next_1d()
        u2b, smp = smp.next_2d()
        bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b,
                                       mode=bsdf_mod.IMPORTANCE)
        throughput = torch.where(active_surface[:, None],
                                 throughput * b_weight, throughput)
        eta = torch.where(active_surface, st.eta * bs.eta, st.eta)
        wo_world = si.to_world(bs.wo)
        non_null = active_surface & ~bs.null
        depth = torch.where(non_null, depth + 1, depth)
        was_transmitted = torch.where(non_null, (flags & F_TRANSMISSION) > 0,
                                      st.was_transmitted)
        medium_depth = torch.where(non_null & was_transmitted, 0,
                                   medium_depth)
        new_medium = torch.where(active_surface & si.is_medium_transition(),
                                 si.target_medium(wo_world), st.medium_idx)

        # next ray
        o_next = torch.where(act_real[:, None], p_coll,
                             torch.where(active_surface[:, None], si.p,
                                         cur_ray.o))
        d_next = torch.where(act_real[:, None], wo_med,
                             torch.where(active_surface[:, None], wo_world,
                                         cur_ray.d))
        mint_next = torch.where(active_surface, m.RayEpsilon, 0.0)

        # VRL bookkeeping: end the segment at a scatter or surface
        vrl_end_ok = vrl_end_med_ok | vrl_end_surf_ok
        end_p = torch.where(act_real[:, None], p_coll, si.p)
        end_len_ok = m.norm(end_p - vrl_start) > min_vrl_len
        vrl_dep = (vrl_start, end_p, st.vrl_flux, st.vrl_medium,
                   st.vrl_depth, st.vrl_direct,
                   vrl_end_ok & end_len_ok & (st.vrl_medium >= 0))

        is_direct = torch.where(act_real, False, st.is_direct)
        restart = act_real | active_surface
        new_vrl_start = torch.where(restart[:, None], o_next, vrl_start)
        new_vrl_flux = torch.where(restart[:, None], st.flux * throughput,
                                   st.vrl_flux)

        alive = (act_real | active_surface) & active
        alive = alive & (throughput != 0).any(dim=-1)
        alive = alive & (~active_surface | (bs.pdf > 0))

        # --- this iteration's deposits into the reservoirs ---------------
        sp_bufs, sp_count, sp_lost = _scatter_rows(
            [raw.sp_pos, raw.sp_power, raw.sp_dir, raw.sp_normal,
             raw.sp_depth, raw.sp_caustic], raw.sp_count, sp_ok,
            [si.p, sp_power, cur_ray.d, si.n, depth, st.was_transmitted],
            sp_cap)
        vp_bufs, vp_count, vp_lost = _scatter_rows(
            [raw.vp_pos, raw.vp_power, raw.vp_dir, raw.vp_depth],
            raw.vp_count, vp_ok, [p_coll, vp_power, cur_ray.d, depth],
            vp_cap)
        # the bend deposits, then the end deposit, step-major
        deps = bend_deps + [vrl_dep]
        v_o = torch.cat([d[0] for d in deps])
        v_e = torch.cat([d[1] for d in deps])
        v_ok2d = torch.stack([d[6] for d in deps])
        v_ok = v_ok2d.reshape(-1) & (m.norm(v_e - v_o) > 1e-6)
        vrl_bufs, vrl_count, vrl_lost = _scatter_rows(
            [raw.vrl_o, raw.vrl_e, raw.vrl_flux, raw.vrl_medium,
             raw.vrl_depth, raw.vrl_direct], raw.vrl_count, v_ok,
            [v_o, v_e] + [torch.cat([d[k] for d in deps])
                          for k in range(2, 6)], vrl_cap)

        raw = raw._replace(
            sp_pos=sp_bufs[0], sp_power=sp_bufs[1], sp_dir=sp_bufs[2],
            sp_normal=sp_bufs[3], sp_depth=sp_bufs[4], sp_caustic=sp_bufs[5],
            sp_count=sp_count, sp_lost=raw.sp_lost + sp_lost,
            vp_pos=vp_bufs[0], vp_power=vp_bufs[1], vp_dir=vp_bufs[2],
            vp_depth=vp_bufs[3], vp_count=vp_count,
            vp_lost=raw.vp_lost + vp_lost,
            vrl_o=vrl_bufs[0], vrl_e=vrl_bufs[1], vrl_flux=vrl_bufs[2],
            vrl_medium=vrl_bufs[3], vrl_depth=vrl_bufs[4],
            vrl_direct=vrl_bufs[5], vrl_count=vrl_count,
            vrl_lost=raw.vrl_lost + vrl_lost,
            sp_contrib=raw.sp_contrib | sp_ok,
            vp_contrib=raw.vp_contrib | vp_ok,
            vrl_contrib=raw.vrl_contrib | v_ok2d.any(dim=0))

        st = ShootState(
            sampler=smp, ray=Ray(o_next, d_next, mint_next, inf),
            throughput=throughput, flux=st.flux, eta=eta, depth=depth,
            medium_depth=medium_depth, was_transmitted=was_transmitted,
            is_direct=is_direct, medium_idx=new_medium, active=alive,
            vrl_start=new_vrl_start, vrl_flux=new_vrl_flux,
            vrl_medium=torch.where(restart, new_medium, st.vrl_medium),
            vrl_depth=torch.where(restart, depth, st.vrl_depth),
            vrl_direct=torch.where(restart, is_direct, st.vrl_direct),
            channel=st.channel)

    # drop the spare rows; count the paths cut by the depth budget or
    # still alive at the end
    return raw._replace(
        trunc_paths=(trunc | st.active).sum(dtype=torch.int32),
        **{f: getattr(raw, f)[:-1] for f in _RESERVOIRS})


def _compact_dev(valid, arrays, cap: int):
    """Compaction to a fixed capacity on the device: valid rows first
    (stable), truncated or padded to ``cap``."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    take = order[:cap]
    n = m.clip(valid.sum(), max=cap)
    vmask = torch.arange(cap, device=valid.device) < n
    return n, vmask, [a[take] for a in arrays]


def photon_radii(grid: hashgrid.HashGrid, pos, valid, k: float = 8.0,
                 max_per_cell: int = 32):
    """Per-photon gather radius from the local density: with ``count``
    neighbours within the cell size r0, r = r0 * (k / count)^(1/3),
    clamped to [r0 / 4, r0]. The cube root is ``pow(x, 1/3)``, within
    two float32 ulps of the reference's ``cbrt`` on these inputs."""
    r0 = grid.cell_size
    r02 = r0 * r0

    def fold(acc, idx, ok):
        d2 = m.squared_norm(pos[idx] - pos[:, None, :])
        sel = ok & valid[idx] & (d2 <= r02)
        return acc + sel.sum(dim=1)

    counts = hashgrid.fold_neighbors(
        grid, pos, valid, fold,
        torch.zeros(pos.shape[:1], device=pos.device), max_per_cell)
    r = r0 * torch.pow(k / m.clip(counts, min=1.0), 1.0 / 3.0)
    return torch.minimum(torch.maximum(r, 0.25 * r0), r0)


def _thin(key, valid, flux, arrays, cap: int):
    """Keep min(count, cap) uniformly random valid rows (without
    replacement) and scale their flux by count / kept: an unbiased
    budget. Returns (kept, vmask, flux_out, arrays_out), cap rows each."""
    n = valid.shape[0]
    dev = valid.device
    r = rng.uniform(key, (n,), dev, flux.dtype)
    order = torch.argsort(torch.where(valid, r, 2.0), stable=True)
    take = order[:cap]
    count = valid.sum(dtype=torch.int32)
    kept = m.clip(count, max=cap)
    vmask = torch.arange(take.shape[0], device=dev) < kept
    scale = count.to(torch.float32) \
        / m.clip(kept, min=1).to(torch.float32)
    flux_out = torch.where(vmask[:, None], flux[take] * scale, 0.0)
    return kept, vmask, flux_out, [a[take] for a in arrays]


def thin_raw(key, raw: RawDeposits, sp_cap: int, vp_cap: int,
             vrl_cap: int) -> RawDeposits:
    """Thin the over-full reservoirs to the map budgets, keeping a
    uniformly random subset with the flux scaled by count / kept: the
    wavefront analog of the reference's shoot-until-full loop, without
    the depth bias a fill-order drop would have."""
    ks, kv, kr = rng.split(key, 3)
    dev = raw.sp_pos.device

    def rows(a, count):
        return torch.arange(a.shape[0], device=dev) < count
    n_sp, _, sp_pow, (sp_pos, sp_dir, sp_nrm, sp_dep, sp_cau) = _thin(
        ks, rows(raw.sp_pos, raw.sp_count), raw.sp_power,
        [raw.sp_pos, raw.sp_dir, raw.sp_normal, raw.sp_depth,
         raw.sp_caustic], sp_cap)
    n_vp, _, vp_pow, (vp_pos, vp_dir, vp_dep) = _thin(
        kv, rows(raw.vp_pos, raw.vp_count), raw.vp_power,
        [raw.vp_pos, raw.vp_dir, raw.vp_depth], vp_cap)
    n_vrl, _, vrl_flux, (vrl_o, vrl_e, vrl_med, vrl_dep, vrl_dir) = _thin(
        kr, rows(raw.vrl_o, raw.vrl_count), raw.vrl_flux,
        [raw.vrl_o, raw.vrl_e, raw.vrl_medium, raw.vrl_depth,
         raw.vrl_direct], vrl_cap)
    return raw._replace(
        sp_pos=sp_pos, sp_power=sp_pow, sp_dir=sp_dir, sp_normal=sp_nrm,
        sp_depth=sp_dep, sp_caustic=sp_cau, sp_count=n_sp,
        vp_pos=vp_pos, vp_power=vp_pow, vp_dir=vp_dir, vp_depth=vp_dep,
        vp_count=n_vp,
        vrl_o=vrl_o, vrl_e=vrl_e, vrl_flux=vrl_flux, vrl_medium=vrl_med,
        vrl_depth=vrl_dep, vrl_direct=vrl_dir, vrl_count=n_vrl)


def pack_vrls(o, d, length, flux, medium, valid):
    """The VRL rows [o(3) d(3) len flux(3) medium valid], one gather a
    record."""
    return torch.cat([o, d, length[:, None], flux,
                      medium.to(torch.float32)[:, None],
                      valid.to(torch.float32)[:, None]], dim=1)


def build_maps(scene, meta, raw: RawDeposits, r_global, r_caustic,
               r_volume) -> PhotonMaps:
    """Hash grids and scale factors over the compact reservoirs. Each map
    is scaled by 1 / the paths shot (not by the paths that deposited, as
    the reference does), which stays unbiased when shot paths can miss
    the scene."""
    dev = raw.sp_pos.device
    n_shot = torch.tensor(float(raw.sp_contrib.shape[0]), device=dev)

    def rows(a, count):
        return torch.arange(a.shape[0], device=dev) < count
    sp_vmask = rows(raw.sp_pos, raw.sp_count)
    vp_vmask = rows(raw.vp_pos, raw.vp_count)
    vrl_vmask = rows(raw.vrl_o, raw.vrl_count)

    seg_c = raw.vrl_e - raw.vrl_o
    vrl_len = m.norm(seg_c)
    vrl_d = seg_c * m.safe_rcp(vrl_len)[:, None]

    lo = scene.bbox_lo
    sp_caustic_b = raw.sp_caustic & sp_vmask
    vp_grid = hashgrid.build(raw.vp_pos, vp_vmask, lo, r_volume)
    vp_rad = photon_radii(vp_grid, raw.vp_pos, vp_vmask)

    def col(x, n):
        return x.to(torch.float32)[:, None] if x is not None \
            else torch.zeros((n, 1), device=dev)
    P, Q = raw.sp_pos.shape[0], raw.vp_pos.shape[0]
    return PhotonMaps(
        sp_pos=raw.sp_pos, sp_power=raw.sp_power, sp_dir=raw.sp_dir,
        sp_normal=raw.sp_normal, sp_depth=raw.sp_depth,
        sp_caustic=sp_caustic_b, sp_valid=sp_vmask,
        global_grid=hashgrid.build(raw.sp_pos, sp_vmask & ~sp_caustic_b,
                                   lo, r_global),
        caustic_grid=hashgrid.build(raw.sp_pos, sp_caustic_b, lo, r_caustic),
        sp_scale=1.0 / n_shot,
        vp_pos=raw.vp_pos, vp_power=raw.vp_power, vp_dir=raw.vp_dir,
        vp_depth=raw.vp_depth, vp_valid=vp_vmask, vp_grid=vp_grid,
        vp_scale=1.0 / n_shot,
        vrl_o=raw.vrl_o, vrl_d=vrl_d, vrl_len=vrl_len,
        vrl_flux=raw.vrl_flux, vrl_medium=raw.vrl_medium,
        vrl_depth=raw.vrl_depth, vrl_direct=raw.vrl_direct,
        vrl_valid=vrl_vmask, vrl_scale=1.0 / n_shot,
        vrl_count=raw.vrl_count,
        sp_lost=raw.sp_lost, vp_lost=raw.vp_lost, vrl_lost=raw.vrl_lost,
        trunc_paths=raw.trunc_paths,
        vrl_packed=pack_vrls(raw.vrl_o, vrl_d, vrl_len, raw.vrl_flux,
                             raw.vrl_medium, vrl_vmask),
        sp_packed=torch.cat(
            [raw.sp_pos, raw.sp_dir, raw.sp_power, col(sp_caustic_b, P),
             col(sp_vmask, P), col(None, P)], dim=1),
        vp_packed=torch.cat(
            [raw.vp_pos, raw.vp_dir, raw.vp_power, vp_rad[:, None],
             col(vp_vmask, Q), col(None, Q)], dim=1),
        vp_radius=vp_rad)


def map_stats(maps: PhotonMaps) -> dict:
    """Map statistics after a preprocess: photon and VRL counts, the
    device bytes of each map (grids included), the deposits dropped at
    capacity and the paths cut at the light-depth cap. Reads a few
    scalars back: call it once, not a pass."""
    def nbytes(*arrs):
        total = 0
        for a in arrs:
            if isinstance(a, torch.Tensor):
                total += a.numel() * a.element_size()
            elif hasattr(a, '_fields'):
                total += nbytes(*a)
        return total

    stats = {
        'surface_photons': int(maps.sp_valid.sum()),
        'caustic_photons': int((maps.sp_valid & maps.sp_caustic).sum()),
        'volume_photons': int(maps.vp_valid.sum()),
        'vrl_count': int(maps.vrl_count),
        'global_map_bytes': nbytes(maps.sp_pos, maps.sp_power, maps.sp_dir,
                                   maps.sp_normal, maps.global_grid),
        'caustic_map_bytes': nbytes(maps.caustic_grid),
        'volume_map_bytes': nbytes(maps.vp_pos, maps.vp_power, maps.vp_dir,
                                   maps.vp_grid),
        'vrl_map_bytes': nbytes(maps.vrl_o, maps.vrl_d, maps.vrl_len,
                                maps.vrl_flux),
    }
    for k in ('sp_lost', 'vp_lost', 'vrl_lost', 'trunc_paths'):
        stats[k] = int(getattr(maps, k))
    return stats


def log_map_stats(maps: PhotonMaps, printer=print) -> None:
    s = map_stats(maps)

    def mem(b):
        return f"{b / 2**20:.2f} MiB" if b >= 2**20 else f"{b / 2**10:.1f} KiB"
    printer(f"  surface photons: {s['surface_photons']} "
            f"({s['caustic_photons']} caustic), "
            f"global map {mem(s['global_map_bytes'])}, "
            f"caustic map {mem(s['caustic_map_bytes'])}")
    printer(f"  volume photons: {s['volume_photons']}, "
            f"map {mem(s['volume_map_bytes'])}")
    printer(f"  VRLs: {s['vrl_count']}, map {mem(s['vrl_map_bytes'])}")
    lost = {k: s[k] for k in ('sp_lost', 'vp_lost', 'vrl_lost',
                              'trunc_paths') if s.get(k)}
    if lost:
        printer(f"  energy-loss diagnostics: {lost}")

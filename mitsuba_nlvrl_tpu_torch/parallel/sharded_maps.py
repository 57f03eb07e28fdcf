"""Photon and VRL maps sharded over a map axis of ranks.

Port of ``mitsuba_nlvrl_tpu/parallel/sharded_maps.py`` on
``torch.distributed``: where the maps outgrow one card, their arrays split
along the photon or VRL axis over the ranks of a map axis (``mp``). Every
density estimate and VRL query is a sum over map entries, so each rank
folds its queries against its own shard (local hash grids, local VRL
clusters) and the partial sums are all-reduced over the axis: the queries
move between ranks, the rays never do.

``shard_photon_axis`` keeps a rank's shard of the maps;
``make_sharded_volume_estimate`` and ``make_sharded_vrl_render`` return
the sharded volume estimate and the whole ``vrl`` or ``photonmapper``
camera pass over a (rays x maps) mesh. Inside the camera pass the VRL
integrator all-reduces each estimate over the axis named by its
``map_psum_axis`` property (``integrators/vrl._map_psum``), bound to the
axis's group for the call's duration. Every rank of a map axis walks the
same camera paths: the sampler and every loop's trip count read only ray
state, so the ranks make the same all-reduces in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import rng
from ..core.ray import Ray
from ..core.rng import Sampler
from ..ops import hashgrid
from ..integrators import photon_est
from ..integrators.lighttrace import PhotonMaps
from . import collectives

# the map arrays with a photon or VRL axis: the reference's map spec
# splits exactly these (the grids' tables are rebuilt on each shard)
PHOTON_AXIS_FIELDS = (
    'sp_pos', 'sp_power', 'sp_dir', 'sp_normal', 'sp_depth', 'sp_caustic',
    'sp_valid', 'vp_pos', 'vp_power', 'vp_dir', 'vp_depth', 'vp_valid',
    'vp_radius', 'vrl_o', 'vrl_d', 'vrl_len', 'vrl_flux', 'vrl_medium',
    'vrl_depth', 'vrl_direct', 'vrl_valid', 'vrl_packed', 'sp_packed',
    'vp_packed')


def shard_photon_axis(maps: PhotonMaps, mesh, axis: str = 'mp'
                      ) -> PhotonMaps:
    """This rank's shard of ``maps`` over ``axis`` of ``mesh``: an array
    whose leading axis is above 1 and divisible by the axis's size is
    split into equal slices, any other is kept whole (replicated); the
    grids' origin and cell size stay whole, and the global VRL clusters
    are dropped (``localize_maps`` and the camera pass rebuild grids and
    clusters per shard). A photon or VRL array that cannot be split
    raises, as the reference's map spec does."""
    _, rank, n = collectives.axis_group(mesh, axis)

    def split(x):
        if x.ndim >= 1 and x.shape[0] > 1 and x.shape[0] % n == 0:
            k = x.shape[0] // n
            return x[rank * k:(rank + 1) * k].contiguous()
        return x

    out = {}
    for f in PhotonMaps._fields:
        v = getattr(maps, f)
        if f == 'clusters':
            out[f] = None
        elif isinstance(v, hashgrid.HashGrid):
            out[f] = v._replace(cell_ranges=split(v.cell_ranges),
                                order=split(v.order))
        else:
            out[f] = split(v)
            if n > 1 and f in PHOTON_AXIS_FIELDS and out[f] is v:
                raise ValueError(
                    f"map array {f} of {tuple(v.shape)} does not split "
                    f"over {n} ranks of axis {axis!r}")
    return PhotonMaps(**out)


def localize_maps(scene, maps: PhotonMaps) -> PhotonMaps:
    """A shard's own view: hash grids over its photons (indices into the
    shard) at the global grids' origin and cell size, and its valid VRL
    count (the deposits are packed, so a shard's valid VRLs are a prefix
    of its slice)."""
    def grid(pos, valid, g):
        return hashgrid.build(pos, valid, g.origin, g.cell_size)
    return maps._replace(
        global_grid=grid(maps.sp_pos, maps.sp_valid & ~maps.sp_caustic,
                         maps.global_grid),
        caustic_grid=grid(maps.sp_pos, maps.sp_caustic, maps.caustic_grid),
        vp_grid=grid(maps.vp_pos, maps.vp_valid, maps.vp_grid),
        vrl_count=maps.vrl_valid.sum(dtype=torch.int32))


def make_sharded_vrl_render(meta, mesh, ray_axis: str = 'dp',
                            map_axis: str = 'mp'):
    """The ``vrl`` or ``photonmapper`` camera pass over a (rays x maps)
    mesh: the wavefront shards over ``ray_axis``, the maps over
    ``map_axis``, and every map estimate is all-reduced over
    ``map_axis``. The sampler of a ray shard takes ``fold_in(key,
    ray_rank)`` over the shard's own lanes, as in the reference, so the
    ranks of one map axis walk the same paths and return the same
    radiance.

    Returns fn(scene, maps_shard, ray, key, info=None) -> (n, 3): the
    radiance of this rank's rows ``[lo, hi)`` of the wavefront ``ray``
    (``collectives.shard_range``); ``maps_shard`` is this rank's
    ``shard_photon_axis``. ``info`` receives the rows, the sampler's
    final dimension, the all-reduces made and the rays."""
    from ..integrators import vrl as vrl_mod
    meta2 = dataclasses.replace(meta, integrator_props=tuple(
        kv for kv in meta.integrator_props if kv[0] != 'map_psum_axis'
    ) + (('map_psum_axis', map_axis),))
    use_pm = meta.integrator in ('photonmapper', 'photonmap')
    sample_fn = vrl_mod.make_sample(use_vrls=not use_pm)
    n_cl = int(meta.iprop('vrl_clusters', 1024))
    use_cut = bool(meta.iprop('use_light_cut', True))
    _, ray_rank, ray_size = collectives.axis_group(mesh, ray_axis)
    map_group, _, _ = collectives.axis_group(mesh, map_axis)

    def fn(scene, maps_shard: PhotonMaps, ray: Ray, key,
           info: Optional[dict] = None):
        collectives.check_backend(map_group, scene.device)
        lo, hi = collectives.shard_range(ray.o.shape[0], ray_rank, ray_size)
        ray_l = Ray(*(x[lo:hi].contiguous() for x in ray))
        n0 = collectives.all_reduces
        with torch.no_grad(), collectives.bind(**{map_axis: map_group}):
            maps_l = localize_maps(scene, maps_shard)
            if use_cut:
                maps_l = maps_l._replace(clusters=vrl_mod.build_vrl_clusters(
                    scene, maps_l, n_cl))
            sampler = Sampler.make(rng.fold_in(key, ray_rank), hi - lo,
                                   scene.device)
            L, _, sampler = sample_fn(scene, meta2, sampler, ray_l,
                                      aux=maps_l)
        if info is not None:
            info.update(rows=(lo, hi), sampler_dim=sampler.dim,
                        all_reduces=collectives.all_reduces - n0,
                        rays=sampler.rays)
        return torch.where(torch.isfinite(L), L, 0.0)

    return fn


def make_sharded_volume_estimate(meta, mesh, axis: str = 'mp'):
    """Returns fn(scene, maps_shard, x, wo, medium_idx, active, radius):
    the volume photon estimate of the queries (the same on every rank)
    against this rank's shard of the maps, all-reduced over ``axis``."""
    group, _, _ = collectives.axis_group(mesh, axis)

    def fn(scene, maps_shard: PhotonMaps, x, wo, medium_idx, active,
           radius):
        collectives.check_backend(group, scene.device)
        g = maps_shard.vp_grid
        local = maps_shard._replace(vp_grid=hashgrid.build(
            maps_shard.vp_pos, maps_shard.vp_valid, g.origin, g.cell_size))
        est = photon_est.estimate_volume(scene, meta, local, x, wo,
                                         medium_idx, active, radius)
        return collectives.all_reduce_sum(est, group)

    return fn

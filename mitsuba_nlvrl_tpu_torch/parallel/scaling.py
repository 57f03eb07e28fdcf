"""The scaling harness and the process-group entry.

Port of ``mitsuba_nlvrl_tpu/parallel/scaling.py`` on ``torch.distributed``.
``init_distributed`` joins this process to the world (one process a
card, as ``torchrun --nproc-per-node=N`` starts them). ``measure_scaling``
renders the same scene on one rank and on n ranks and reports the rays a
second of each and the efficiency; under gloo on the CPU it validates the
program and its collectives only, and only NCCL across cards makes it a
statement about hardware. ``dp_fold_proxy`` and ``weak_scaling_proxy`` are
what one card can say about data parallelism: whether a folded shard
reaches the rate of a full wavefront, and whether the rate is flat in
the wavefront's size.

Every rate this module reports is held to a plausibility bound: at most
``PLAUSIBLE_FACTOR`` (4) times the steady rate of ``render`` on the same
scene in the same process (``steady_render_rate``, or the ``ceiling`` a
caller passes), times the wavefront's lanes over the film's pixels where
the wavefront is the larger (``lane_bound``): the render is paced by its
launches, a fixed number a pass, so its rate grows at most in proportion
to the lanes each launch carries. A rate above it, or one that is not
positive and finite, raises ``ImplausibleRate``: a rate far above what
the renderer itself reaches was not measured, it was a timing fault.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

import torch

from ..core import rng
from ..core.rng import Lanes, Sampler
from .. import sensor as sensor_mod
from ..integrators import get_integrator
from ..integrators.common import film_sample_positions
from . import collectives

PLAUSIBLE_FACTOR = 4.0
# the clock of every rate
_clock = time.perf_counter


class ImplausibleRate(RuntimeError):
    """A reported rate outside its plausibility bound."""


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device='cuda') -> int:
    """Join the process group; returns this process's rank.

    With ``init_method`` (``tcp://host:port`` or ``file:///path``) the
    caller gives ``world_size`` and ``rank``; without it they come from
    the environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). The backend is the device's:
    NCCL for 'cuda' (each process takes card ``LOCAL_RANK``, else its
    rank, modulo the cards it sees), gloo for 'cpu'."""
    import torch.distributed as dist
    if init_method is None:
        missing = [k for k in ('MASTER_ADDR', 'MASTER_PORT')
                   if k not in os.environ]
        if world_size is None:
            missing += [] if 'WORLD_SIZE' in os.environ else ['WORLD_SIZE']
        if rank is None:
            missing += [] if 'RANK' in os.environ else ['RANK']
        if missing:
            raise RuntimeError(f"init_distributed without init_method reads "
                               f"{', '.join(missing)} from the environment "
                               f"(torchrun sets them)")
        init_method = 'env://'
        world_size = int(os.environ['WORLD_SIZE']) if world_size is None \
            else world_size
        rank = int(os.environ['RANK']) if rank is None else rank
    elif world_size is None or rank is None:
        raise ValueError("init_method needs world_size and rank")
    if torch.device(device).type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(collectives.backend_for(device),
                            init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank()


def check_rate(name: str, rate: float, ceiling: float) -> float:
    """``rate`` (rays/s) where it is positive, finite and at most
    ``ceiling``; else ``ImplausibleRate``."""
    if not (math.isfinite(rate) and 0.0 < rate <= ceiling):
        raise ImplausibleRate(
            f"{name}: {rate:.6g} rays/s is outside (0, {ceiling:.6g}], "
            f"{PLAUSIBLE_FACTOR:g} x the steady render rate of the same "
            f"scene in this process")
    return rate


def lane_bound(ceiling: float, meta, lanes: int) -> float:
    """The bound of a wavefront of ``lanes``: ``ceiling`` (the film's),
    scaled by the lanes over the film's pixels where they are more."""
    return ceiling * max(1.0, lanes / (meta.film.width * meta.film.height))


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def steady_render_rate(scene, meta, passes: int = 2, seed: int = 3,
                       aux=None) -> float:
    """Rays a second of ``render.render_pass`` on the scene's own film,
    after one warm-up pass: the rate the plausibility bound scales."""
    from ..render import render_pass
    key = rng.PRNGKey(seed)
    dev = scene.device
    render_pass(scene, meta, rng.fold_in(key, 99), 0, aux)
    _sync(dev)
    t0 = _clock()
    rays = [render_pass(scene, meta, rng.fold_in(key, p), p, aux)[1]
            for p in range(passes)]
    _sync(dev)
    dt = _clock() - t0
    return float(sum(float(r) for r in rays)) / max(dt, 1e-12)


def _ceiling(scene, meta, ceiling, aux=None) -> float:
    if ceiling is not None:
        return ceiling
    return PLAUSIBLE_FACTOR * steady_render_rate(scene, meta, aux=aux)


def _render_rays_per_s(scene, meta, mesh, passes: int = 4, seed: int = 7,
                       integrator: Optional[str] = None, aux=None):
    """(rays/s, mean checksum a pass) of one pass's wavefront sharded over
    the ``dp`` axis of ``mesh``: each rank draws the numbers of its
    lanes of the global wavefront, and the checksum (the sum of the
    radiance) and the rays are summed over the axis."""
    integ = get_integrator(integrator or meta.integrator)
    group, rank, size = collectives.axis_group(mesh, 'dp')
    collectives.check_backend(group, scene.device)
    dev = scene.device
    key = rng.PRNGKey(seed)
    _, pos01 = film_sample_positions(meta, key, 0, dev)
    N = pos01.shape[0]
    lo, hi = collectives.shard_range(N, rank, size)
    lanes = Lanes(torch.arange(lo, hi, dtype=torch.int64, device=dev), N)
    pos_l = pos01[lo:hi]

    def one_pass(k):
        with torch.no_grad():
            ray, _ = sensor_mod.sample_ray(
                scene, meta, pos_l, rng.uniform(
                    rng.fold_in(k, 1), (hi - lo, 2), dev, scene.dtype,
                    lanes=lanes))
            sampler = Sampler.make(rng.fold_in(k, 2), hi - lo, dev, at=lanes)
            L, _, sampler = integ(scene, meta, sampler, ray, aux=aux)
            out = torch.stack([
                torch.where(torch.isfinite(L), L, 0.0).double().sum(),
                sampler.rays.double()])
            return collectives.all_reduce_sum(out, group)

    one_pass(key)
    _sync(dev)
    t0 = _clock()
    outs = [one_pass(rng.fold_in(key, p)) for p in range(passes)]
    _sync(dev)
    dt = _clock() - t0
    tot = torch.stack(outs).sum(dim=0).cpu()
    return float(tot[1]) / max(dt, 1e-12), float(tot[0]) / passes


def measure_scaling(scene, meta, n_devices: Optional[int] = None,
                    passes: int = 4, integrator: Optional[str] = None,
                    aux=None, ceiling: Optional[float] = None) -> dict:
    """Render on a one-rank group (rank 0) and on the first n ranks;
    returns the same dict on every rank: {n, integrator, rays_per_s_1,
    rays_per_s_n, efficiency, checksum_rel_diff, backend,
    hardware_valid, note, ceiling}.

    Every rank makes both groups; the ranks outside one wait at a
    barrier while it renders, never on its collectives. The two renders
    draw the same numbers (global lanes), so their checksums agree to
    the order of the sums. ``hardware_valid`` is False under gloo on the
    CPU, where ranks share the cores: the efficiency is then core
    contention and not a scaling statement. Each rate is held to the
    plausibility bound (n times it for n ranks)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("measure_scaling needs the process group "
                           "(init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    g1 = dist.new_group([0])
    gn = dist.new_group(list(range(n)))
    if ceiling is None and rank < n:
        ceiling = _ceiling(scene, meta, None, aux)
    rec = None
    if rank == 0:
        r1, c1 = _render_rays_per_s(scene, meta, g1, passes,
                                    integrator=integrator, aux=aux)
        check_rate('rays_per_s_1', r1, ceiling)
    dist.barrier()
    if rank < n:
        rn, cn = _render_rays_per_s(scene, meta, gn, passes,
                                    integrator=integrator, aux=aux)
        check_rate('rays_per_s_n', rn, n * ceiling)
    dist.barrier()
    if rank == 0:
        backend = str(dist.get_backend())
        hw = 'nccl' in backend
        note = ''
        if not hw:
            note = ('gloo on the CPU: program validation only; the '
                    'efficiency is core contention, not a scaling '
                    'statement')
        elif n == 1:
            note = 'one rank: no scaling measured'
        rec = {'n': n, 'integrator': integrator or meta.integrator,
               'rays_per_s_1': r1, 'rays_per_s_n': rn,
               'efficiency': rn / (n * r1) if r1 > 0 else 0.0,
               'checksum_rel_diff': abs(cn - c1) / max(abs(c1), 1e-9),
               'backend': backend, 'hardware_valid': hw, 'note': note,
               'ceiling': ceiling}
    box = [rec]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _proxy_pass(integ, scene, meta, key, npix: int, n_fold: int):
    """One wavefront of ``npix`` random film positions repeated
    ``n_fold`` times (lane = fold x position, every lane its own
    numbers): (checksum, rays)."""
    dev = scene.device
    u = rng.uniform(key, (npix, 2), dev)
    posf = u.repeat(n_fold, 1)
    n = posf.shape[0]
    ray, _ = sensor_mod.sample_ray(scene, meta, posf, rng.uniform(
        rng.fold_in(key, 1), (n, 2), dev, scene.dtype))
    sampler = Sampler.make(rng.fold_in(key, 2), n, dev)
    L, _, sampler = integ(scene, meta, sampler, ray)
    return torch.where(torch.isfinite(L), L, 0.0).sum(), sampler.rays


def _best_rate(integ, scene, meta, key, npix, n_fold, passes, warm) -> float:
    """The best rays/s of ``passes`` timed wavefronts after two warm-up
    ones (``fold_in(key, warm + w)``)."""
    dev = scene.device
    with torch.no_grad():
        for w in range(2):
            _proxy_pass(integ, scene, meta, rng.fold_in(key, warm + w),
                        npix, n_fold)
            _sync(dev)
        best = math.inf
        for p in range(passes):
            t0 = _clock()
            _, r = _proxy_pass(integ, scene, meta, rng.fold_in(key, p),
                               npix, n_fold)
            _sync(dev)
            dt = _clock() - t0
            best = min(best, dt / float(r))
    return 1.0 / best


def dp_fold_proxy(scene, meta, shard_lanes: int = 32768, folds: int = 8,
                  passes: int = 3, seed: int = 13,
                  ceiling: Optional[float] = None) -> dict:
    """One card's evidence for pass folding (``render_dist.dp_fold_for``):
    the rate of a ``shard_lanes`` shard with ``folds`` passes folded into
    the lane dimension (the sharded path's dispatch shape) against the
    rate of the full wavefront (``shard_lanes * folds`` lanes, one
    pass). A ratio near 1 says a rank holding 1/folds of the film reaches
    the full card's rate by folding. Rates are best of ``passes``, each
    under the plausibility bound."""
    integ = get_integrator(meta.integrator)
    ceiling = _ceiling(scene, meta, ceiling)
    key = rng.PRNGKey(seed)
    bound = lane_bound(ceiling, meta, shard_lanes * folds)
    folded = check_rate('folded', _best_rate(
        integ, scene, meta, key, shard_lanes, folds, passes, 99), bound)
    full = check_rate('full', _best_rate(
        integ, scene, meta, key, shard_lanes * folds, 1, passes, 99), bound)
    return {'backend': scene.device.type, 'shard_lanes': shard_lanes,
            'folds': folds, 'folded_mrays': folded / 1e6,
            'full_mrays': full / 1e6, 'ratio': folded / max(full, 1e-9),
            'ceiling_mrays': ceiling / 1e6, 'bound_mrays': bound / 1e6}


def weak_scaling_proxy(scene, meta, base: int = 32768,
                       factors=(1, 2, 4, 8), passes: int = 3,
                       seed: int = 11,
                       ceiling: Optional[float] = None) -> dict:
    """One card's weak-scaling proxy: data parallelism runs a fixed
    wavefront on every rank, so what one card can say is whether its rate
    is flat from that size up. Returns {sizes, rays_per_s, per_ray_flat}
    (the rate at the largest size over the rate at the smallest); every
    rate is best of ``passes`` and under the plausibility bound of its
    wavefront (``lane_bound``)."""
    integ = get_integrator(meta.integrator)
    ceiling = _ceiling(scene, meta, ceiling)
    key = rng.PRNGKey(seed)
    out = {}
    for f in factors:
        n = base * f
        out[n] = check_rate(f'lanes_{n}', _best_rate(
            integ, scene, meta, key, n, 1, passes, 90),
            lane_bound(ceiling, meta, n))
    sizes = sorted(out)
    return {'backend': scene.device.type, 'sizes': sizes,
            'rays_per_s': [out[s] for s in sizes],
            'per_ray_flat': out[sizes[-1]] / max(out[sizes[0]], 1e-9),
            'ceiling_mrays': ceiling / 1e6,
            'bounds_mrays': [lane_bound(ceiling, meta, s) / 1e6
                             for s in sizes]}

"""Data-parallel rendering: the film wavefront sharded over ranks.

Port of ``mitsuba_nlvrl_tpu/parallel/render_dist.py`` on
``torch.distributed``. The reference shards the wavefront over a
``jax.sharding`` mesh and lets XLA insert the collectives; here each rank
of the mesh's ``dp`` axis renders its shard of the pixels, splats it into
a film of its own, and the films are summed over the axis with one
all-reduce a dispatch (the analog of ``Film::put`` merging blocks, over
ranks instead of threads). Every draw keeps the reference's global
semantics: a rank draws the jitter, sensor and sampler numbers of its
lanes of the global wavefront (``core/rng.Lanes``), so any number of
ranks renders the image that one rank renders.

The backend follows the scene's device (``parallel/collectives.py``):
NCCL on the card, gloo on the CPU; a mesh of another backend raises.
``mesh=None`` renders the whole wavefront in this process, with no
collective.

``render_wavefront`` is the pure function of (scene, positions, key) that
``autodiff.py`` calls once a pass; ``train_step`` differentiates it.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..core import rng
from ..core.rng import Lanes, Sampler
from .. import film as film_mod
from .. import sensor as sensor_mod
from ..integrators import get_integrator
from . import collectives

# the per-rank wavefront that saturates the card: below it a dispatch is
# paced by the host, so passes fold into the lane dimension until each
# rank's shard reaches it. From the weak-scaling sweep of chip_smoke.py
# (``weak_scaling_proxy`` on the 512x512 Cornell box, ``path`` max_depth
# 8; NVIDIA H100 80GB HBM3, 700.00 W): 0.67, 1.68, 3.10, 5.76, 11.97,
# 21.03, 24.76 and 27.85 Mrays/s at 32,768 to 4,194,304 lanes. The eager
# bounce loop is paced by its launches, so the rate grows with the lanes
# a launch carries until about a million; this is the smallest wavefront
# within 90% of the sweep's best rate (2,097,152 lanes read 88.9%).
SATURATION_LANES = 4194304


def make_mesh(device='cuda', shape=None, axes=('dp',)):
    """A ``DeviceMesh`` over the whole world, its dimensions named
    ``axes`` (default one ``dp`` axis of every rank; ``shape=(dp, mp)``
    with ``axes=('dp', 'mp')`` for the map-sharded render). The process
    group must be up (``scaling.init_distributed``); ``device`` is where
    the ranks' tensors lie, 'cuda' unless the caller says 'cpu'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.scaling.init_distributed first")
    shape = (dist.get_world_size(),) if shape is None else tuple(shape)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def dp_fold_for(meta, mesh_or_n, spp: int) -> int:
    """Passes to fold into each dispatch so that every rank's shard
    reaches ``SATURATION_LANES`` lanes (at most ``spp``). ``mesh_or_n``:
    a mesh (its ``dp`` axis), a rank count, or None (one rank). Folding
    keeps the estimator: every lane keeps its own jitter and stream."""
    if mesh_or_n is None or isinstance(mesh_or_n, int):
        n_dev = mesh_or_n or 1
    else:
        n_dev = collectives.axis_group(mesh_or_n, 'dp')[2]
    npix = meta.film.width * meta.film.height
    per_dev = max(1, npix // max(n_dev, 1))
    return int(max(1, min(spp, -(-SATURATION_LANES // per_dev))))


def _pixel_base(meta, device=None) -> torch.Tensor:
    """The (npix, 2) pixel corners, row-major."""
    W, H = meta.film.width, meta.film.height
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing='ij')
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def _wavefront(scene, meta, pos, key, integrator=None, diff=False,
               lanes: Optional[Lanes] = None):
    """``render_wavefront``'s radiance and the sampler after it (its ray
    count); ``lanes``: the positions' places in a global wavefront."""
    integ = get_integrator(integrator or meta.integrator)
    W, H = meta.film.width, meta.film.height
    dev = pos.device
    scale = torch.tensor([1.0 / W, 1.0 / H], dtype=torch.float32,
                         device=dev)
    N = pos.shape[0]
    ray, sensor_weight = sensor_mod.sample_ray(
        scene, meta, pos * scale, rng.uniform(rng.fold_in(key, 1), (N, 2),
                                              dev, scene.dtype, lanes=lanes))
    sampler = Sampler.make(rng.fold_in(key, 2), N, dev, at=lanes)
    L, _, sampler = integ(scene, meta, sampler, ray, diff=diff)
    return torch.where(torch.isfinite(L), L, 0.0) * sensor_weight, sampler


def render_wavefront(scene, meta, pos, key, integrator: Optional[str] = None,
                     diff: bool = False):
    """Radiance (N, 3) of the film positions ``pos`` (N, 2 pixel
    coordinates). The sensor's sample takes ``fold_in(key, 1)`` and the
    sampler ``fold_in(key, 2)``, as in the reference; ``diff=True`` selects
    the integrators' differentiable bounce loops."""
    return _wavefront(scene, meta, pos, key, integrator, diff)[0]


def _one_dispatch(scene, meta, base, pix, key, integrator, n_fold: int):
    """One dispatch on this rank: its pixels ``pix`` (their corners
    ``base``) in each of ``n_fold`` folded passes, the global lanes
    ``f * npix + p``, each with its own jitter (``fold_in(key, 0xf17)``)
    and stream. Returns (the rank's film, its rays)."""
    dev = base.device
    npix = meta.film.width * meta.film.height
    ids = (torch.arange(n_fold, dtype=torch.int64, device=dev)[:, None]
           * npix + pix[None, :]).reshape(-1)
    lanes = Lanes(ids, n_fold * npix)
    n = ids.shape[0]
    posf = base.repeat(n_fold, 1) + rng.uniform(
        rng.fold_in(key, 0xf17), (n, 2), dev, scene.dtype, lanes=lanes)
    L, sampler = _wavefront(scene, meta, posf, key, integrator, lanes=lanes)
    image = film_mod.splat(meta.film, posf, L,
                           torch.ones((n,), dtype=L.dtype, device=dev),
                           film_mod.new_image(meta.film, dev, scene.dtype))
    return image, sampler.rays


def _rank_pixels(meta, rank: int, size: int, device):
    """(global pixel ids, their corners) of a rank's ``dp`` shard."""
    npix = meta.film.width * meta.film.height
    lo, hi = collectives.shard_range(npix, rank, size)
    pix = torch.arange(lo, hi, dtype=torch.int64, device=device)
    return pix, _pixel_base(meta, device)[lo:hi]


def render_distributed(scene, meta, mesh=None, seed: int = 0,
                       spp: Optional[int] = None,
                       integrator: Optional[str] = None,
                       fold: Optional[int] = None,
                       info: Optional[dict] = None):
    """Render with the wavefront sharded over the ``dp`` axis of ``mesh``
    (None: this process alone); (H, W, 3) on every rank.

    ``fold`` passes are folded into each dispatch's lane dimension (lane
    = pass x pixel; default ``dp_fold_for``): a small shard would
    otherwise leave the card waiting on the host every pass. Each
    dispatch's films are summed over the axis (one all-reduce), the
    dispatches summed, and the film developed on every rank. ``info``
    receives the fold, the dispatches, the rays of all ranks and the
    all-reduces."""
    spp = spp or meta.spp
    group, rank, size = collectives.axis_group(mesh, 'dp')
    collectives.check_backend(group, scene.device)
    if fold is None:
        fold = dp_fold_for(meta, size, spp)
    key = rng.PRNGKey(seed)
    dev = scene.device
    pix, base = _rank_pixels(meta, rank, size, dev)
    n0 = collectives.all_reduces
    acc, rays, dispatches = None, torch.zeros((), dtype=torch.float64,
                                              device=dev), 0
    with torch.no_grad():
        p = 0
        while p < spp:
            n_fold = min(fold, spp - p)
            img, r = _one_dispatch(scene, meta, base, pix,
                                   rng.fold_in(key, p), integrator, n_fold)
            img = collectives.all_reduce_sum(img, group)
            acc = img if acc is None else acc + img
            rays = rays + r
            dispatches += 1
            p += n_fold
        rays = collectives.all_reduce_sum(rays, group)
    if info is not None:
        info.update(fold=fold, dispatches=dispatches, rays=rays,
                    ranks=size, all_reduces=collectives.all_reduces - n0)
    return film_mod.develop(acc)


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def measure_fold(scene, meta, folds: int = 8, seed: int = 5,
                 reps: int = 3, mesh=None) -> dict:
    """Time the sharded path end to end at one rank: ``render_distributed``
    itself (host loop, all-reduce where ``mesh`` has a group, develop) at
    ``folds`` spp with fold=``folds`` (one wide dispatch) and with fold=1
    (``folds`` narrow ones), and the dispatch alone (no all-reduce, no
    develop) as the saturation reference. Size the film to a rank's
    shard (the reference's 32,768 pixels).

    Returns {backend, pixels, folds, latency_fold_s, wall_fold_s,
    wall_nofold_s, kernel_s, ratio, speedup}: ``wall_fold_s`` is the
    steady wall a render (``reps`` renders back to back, one
    synchronisation), ``latency_fold_s`` one render alone; ``ratio`` =
    kernel_s / wall_fold_s (the share of the render that is its
    dispatch), ``speedup`` = wall_nofold_s / wall_fold_s (what folding
    buys end to end)."""
    import torch.distributed as dist
    dev = scene.device
    spp = folds

    def timed(fold):
        render_distributed(scene, meta, mesh, seed=seed, spp=spp, fold=fold)
        _sync(dev)                                          # warm-up
        t0 = time.perf_counter()
        render_distributed(scene, meta, mesh, seed=seed + 1, spp=spp,
                           fold=fold)
        _sync(dev)
        latency = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(reps):
            render_distributed(scene, meta, mesh, seed=seed + 2 + i,
                               spp=spp, fold=fold)
        _sync(dev)
        return latency, (time.perf_counter() - t0) / reps

    lat_fold, wall_fold = timed(folds)
    _, wall_nofold = timed(1)

    # the dispatch alone, back to back, one synchronisation
    group, rank, size = collectives.axis_group(mesh, 'dp')
    pix, base = _rank_pixels(meta, rank, size, dev)
    key = rng.PRNGKey(seed)
    with torch.no_grad():
        _one_dispatch(scene, meta, base, pix, key, None, folds)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            _one_dispatch(scene, meta, base, pix, rng.fold_in(key, i), None,
                          folds)
        _sync(dev)
    kernel = (time.perf_counter() - t0) / reps
    return {
        'backend': dev.type,
        'dist_backend': None if group is None else str(
            dist.get_backend(group)),
        'pixels': int(meta.film.width * meta.film.height),
        'folds': folds,
        'latency_fold_s': lat_fold,
        'wall_fold_s': wall_fold,
        'wall_nofold_s': wall_nofold,
        'kernel_s': kernel,
        'ratio': kernel / max(wall_fold, 1e-9),
        'speedup': wall_nofold / max(wall_fold, 1e-9),
    }


def _leaves(params):
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def _rebuild(params, values):
    if isinstance(params, torch.Tensor):
        return values[0]
    if isinstance(params, dict):
        return dict(zip(params.keys(), values))
    return type(params)(values)


def train_step(scene, meta, params, ref_image, key, param_merge):
    """One differentiable render step: the L2 loss of a 1 spp render
    against ``ref_image`` and its gradient with respect to ``params`` (a
    tensor, or a dict, list or tuple of tensors), which
    ``param_merge(scene, params)`` puts into the scene. The positions
    take ``fold_in(key, 0)``, as in the reference. Returns (loss, grads)
    with ``grads`` shaped as ``params``."""
    from ..integrators.common import film_sample_positions
    dev = scene.device
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with torch.enable_grad():
        sc = param_merge(scene, _rebuild(params, leaves))
        pos, _ = film_sample_positions(meta, rng.fold_in(key, 0), 0, dev)
        L = render_wavefront(sc, meta, pos, key, diff=True)
        image = film_mod.splat(meta.film, pos, L,
                               torch.ones((pos.shape[0],), dtype=L.dtype,
                                          device=dev),
                               film_mod.new_image(meta.film, dev,
                                                  scene.dtype))
        loss = ((film_mod.develop(image) - ref_image) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _rebuild(params, grads)

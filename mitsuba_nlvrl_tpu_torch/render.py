"""Top-level render orchestration.

Port of ``mitsuba_nlvrl_tpu/render.py`` without bands: one *pass* renders
a full-film wavefront at 1 spp and splats it, and passes loop on the host
up to the target spp. The pass keys are those of the reference
(``fold_in(PRNGKey(seed), p)`` for pass p), so both packages trace the
same paths for the same seed. Two-pass integrators (``vrl``,
``photonmapper``, also inside a ``moment``, ``stokes`` or ``aov``
wrapper) run their photon and VRL shooting (``preprocess``) once, with
the reference's key, and hand the maps (``aux``) to every pass. With
``MNT_REGEN=1`` a volumetric ``volpath`` render or a ``path`` render
takes the regeneration scheduler instead (``integrators/regen.py``), as
the reference does off TPU; the pass loop stays the default. The render
runs where the scene's tensors lie, under ``torch.no_grad()``; the
differentiable render is ``autodiff.render``. ``preprocess`` called on
its own records autograd history, as the reference's light pass is
differentiable.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from .core import rng
from .core.rng import Sampler
from . import film as film_mod
from . import sensor as sensor_mod
from .integrators import get_integrator, get_preprocess
from .integrators.common import film_sample_positions
from .integrators.regen import regen_supported, render_regen
from .scene.types import unwrap


def preprocess(scene, meta, seed: int = 0):
    """The integrator's preprocess (photon and VRL shooting), or None for
    a one-pass integrator; its key is the reference's,
    ``fold_in(PRNGKey(seed), 0x9e37)``. A wrapper integrator (``moment``,
    ``stokes``, ``aov``) runs the preprocess of the one it wraps. The
    light pass is differentiable, as the reference's is: where a scene
    leaf requires grad, the maps carry its gradient."""
    inner = unwrap(meta)
    pre = get_preprocess(inner.integrator)
    if pre is None:
        return None
    return pre(scene, inner, rng.fold_in(rng.PRNGKey(seed), 0x9e37))


def _use_regen(meta, should_stop, on_pass, timeout) -> bool:
    """The reference's gate off TPU: opt-in (``MNT_REGEN=1``), for a
    volumetric ``volpath``/``volpathmis`` render or a ``path`` render
    with a decomposable sampler, not spectral, and without per-pass
    hooks."""
    name = meta.integrator
    volumetric = name in ('volpath', 'volpathmis') and meta.has_media
    return (os.environ.get('MNT_REGEN', '') == '1'
            and regen_supported(meta, name, diff=False)
            and should_stop is None and on_pass is None and timeout is None
            and (volumetric or name == 'path'))


def render_pass(scene, meta, key, pass_idx: int = 0, aux=None):
    """One 1-spp pass over the full film; returns ((H, W, 4) premultiplied
    [rgb * weight, weight] accumulation, measured ray count). ``aux``: the
    maps of a two-pass integrator."""
    integ = get_integrator(meta.integrator)
    dev = scene.device
    with torch.no_grad():
        pos_key, samp_key = rng.split(key)
        pos, pos01 = film_sample_positions(meta, pos_key, pass_idx, dev)
        N = pos.shape[0]
        ray, sensor_weight = sensor_mod.sample_ray(
            scene, meta, pos01, rng.uniform(rng.fold_in(pos_key, 1), (N, 2),
                                            dev, scene.dtype))
        sampler = Sampler.make(samp_key, N, dev)
        L, valid, sampler = integ(scene, meta, sampler, ray, aux=aux)
        L = torch.where(torch.isfinite(L), L, 0.0) * sensor_weight
        image = film_mod.new_image(meta.film, dev, scene.dtype)
        # the camera wavefront is pixel-ordered: dense shifted-add splat
        jitter = pos - torch.floor(pos)
        image = film_mod.splat_pixel_ordered(meta.film, jitter, L, image)
    return image, sampler.rays


def render(scene, meta, seed: int = 0, spp: Optional[int] = None,
           ray_stats: Optional[list] = None, info: Optional[dict] = None,
           aux=None, verbose: bool = False,
           timeout: Optional[float] = None, should_stop=None, on_pass=None):
    """Full render: the preprocess where the integrator has one (unless
    ``aux`` brings its maps), then ``spp`` passes -> (H, W, 3) image on the
    scene's device.

    If ``ray_stats`` is a list, each pass appends its measured ray count
    (a device scalar: read it after the render; a chunk of the
    regeneration scheduler appends one). ``info`` receives
    ``passes_done``, ``stopped_early``, ``wall_s`` and ``preprocess_s``
    (the preprocess's share of ``wall_s``), and ``scheduler`` 'regen'
    where the regeneration scheduler rendered.

    Cooperative cancellation, as the reference's: ``timeout`` seconds
    (of passes, the preprocess not counted) and a ``should_stop()``
    callable are checked after each pass; when either fires the render
    stops and develops the passes done so far (the weight channel
    normalises any pass count). ``on_pass(p, develop)``
    runs after pass ``p`` with a function that develops the film so far
    (the CLI writes it on SIGHUP). ``verbose`` prints a line a pass."""
    spp = spp or meta.spp
    if _use_regen(meta, should_stop, on_pass, timeout):
        t0 = time.time()
        acc = render_regen(scene, meta, seed=seed, spp=spp,
                           ray_stats=ray_stats, verbose=verbose)
        if scene.device.type == 'cuda':
            torch.cuda.synchronize(scene.device)
        if info is not None:
            info.update(passes_done=spp, stopped_early=False,
                        wall_s=time.time() - t0, preprocess_s=0.0,
                        scheduler='regen')
        return film_mod.develop(acc)
    key = rng.PRNGKey(seed)
    acc = None
    t0 = time.time()
    if aux is None:
        with torch.no_grad():
            aux = preprocess(scene, meta, seed)
    if scene.device.type == 'cuda':
        torch.cuda.synchronize(scene.device)
    t_pre = time.time() - t0
    t_loop = time.time()    # the timeout counts the passes alone
    done = 0
    while done < spp:
        p = done
        img, nrays = render_pass(scene, meta, rng.fold_in(key, p), p, aux)
        acc = img if acc is None else acc + img
        if ray_stats is not None:
            ray_stats.append(nrays)
        done = p + 1
        if verbose:
            print(f"  pass {done}/{spp}  ({time.time() - t0:.2f}s)")
        if on_pass is not None:
            on_pass(p, lambda acc=acc: film_mod.develop(acc))
        if (should_stop is not None and should_stop()) \
                or (timeout is not None and time.time() - t_loop > timeout):
            if verbose:
                print(f"  [stop] after pass {done}/{spp} "
                      f"({time.time() - t0:.2f}s): developing the partial "
                      f"film")
            break
    if scene.device.type == 'cuda':
        torch.cuda.synchronize(scene.device)
    if info is not None:
        info['passes_done'] = done
        info['stopped_early'] = done < spp
        info['wall_s'] = time.time() - t0
        info['preprocess_s'] = t_pre
    return film_mod.develop(acc)

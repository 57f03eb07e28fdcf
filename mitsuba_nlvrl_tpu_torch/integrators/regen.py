"""Persistent-wavefront scheduler with path regeneration.

Port of ``mitsuba_nlvrl_tpu/integrators/regen.py``. Instead of one
film-size wavefront a pass that drains to its slowest lane, one wavefront
of ``n_lanes`` lanes stays alive for a chunk of passes: each outer
iteration first retires finished paths into a per-path output buffer and
refills their lanes with fresh camera rays from a path queue, then runs
one iteration of the ``volpath`` (or ``path``) bounce body, the estimator
the pass loop runs. Unfinished collision and transmittance walks carry
over to the next iteration as lane state.

The reference runs a fixed ``ITERS_PER_DISPATCH`` iterations in one
``fori_loop`` dispatch and reads the pending count (unissued plus live
paths) of the previous dispatch after queueing the next. Here the
dispatch is a host loop of the same iterations, and the pending count is
read once a dispatch (``core/sync.py`` counts the read), one dispatch
behind, so the iterations run are the reference's and the last
dispatch retires the paths that ended in the one before.

The film jitter of the refill's camera rays and of the splat must agree,
so the scheduler needs a jitter that is a function of (pass, pixel)
alone (``sampler.lane_jitter``, the ``REGEN_SAMPLERS``). ``render``
takes it only when asked (``MNT_REGEN=1``), as the reference does off
TPU; the pass loop stays the default.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core import rng
from ..core.ray import Ray
from ..core.records import SurfaceInteraction
from ..core.rng import Sampler
from ..core.sync import int_on_host
from .. import film as film_mod
from .. import sensor as sensor_mod
from ..sampler import REGEN_SAMPLERS, lane_jitter, lane_uniform2
from . import path as path_mod
from . import volpath

# outer iterations a dispatch (the reference's fori_loop length)
ITERS_PER_DISPATCH = 24
# a path alive this many iterations is retired with what it gathered
LANE_ITER_CAP = volpath.MAX_WAVEFRONT_ITERS
# cap on the per-chunk path buffer; a render processes pass chunks of at
# most this many paths
MAX_CHUNK_PATHS = 4 << 20
# the salt of the refill's aperture uniforms
_APERTURE_SALT = 0x0a9e31
# the path family's wavefront width, the reference's default
PATH_LANES = 1 << 16


class RegenState(NamedTuple):
    vp: object              # VolpathState or PathState
    pid: torch.Tensor       # (N,) int64 chunk-local path id; -1 = empty
    lane_it: torch.Tensor   # (N,) int32 iterations this path has run
    queue: torch.Tensor     # () int64 next unissued path id
    out: torch.Tensor       # (n_paths + 1, 3) retired radiance; the last
    #                         row takes the lanes that retire nothing


def _family(name: str):
    if name in ('volpath', 'volpathmis'):
        return 'volpath'
    if name == 'path':
        return 'path'
    return None


def _genesis(meta, key, n_lanes: int, n_paths: int, family: str,
             device) -> RegenState:
    N = n_lanes
    z3 = torch.zeros((N, 3), device=device)
    d0 = z3.clone()
    d0[:, 2] = 1.0
    ray = Ray(z3.clone(), d0, torch.zeros((N,), device=device),
              torch.full((N,), float('inf'), device=device))
    common = dict(
        sampler=Sampler.make(key, N, device), ray=ray,
        throughput=torch.ones((N, 3), device=device),
        result=torch.zeros((N, 3), device=device),
        eta=torch.ones((N,), device=device),
        depth=torch.zeros((N,), dtype=torch.int32, device=device),
        active=torch.zeros((N,), dtype=torch.bool, device=device))
    if family == 'path':
        vp = path_mod.PathState(
            **common, prev_pdf=torch.ones((N,), device=device),
            prev_delta=torch.ones((N,), dtype=torch.bool, device=device),
            prev_p=z3.clone())
    else:
        vp = volpath.VolpathState(
            **common,
            medium_idx=torch.full((N,), -1, dtype=torch.int32,
                                  device=device),
            channel=torch.zeros((N,), dtype=torch.int32, device=device),
            si=SurfaceInteraction.invalid((N,), device),
            needs_isect=torch.ones((N,), dtype=torch.bool, device=device),
            em_full=torch.ones((N,), dtype=torch.bool, device=device),
            prev_pdf=torch.zeros((N,), device=device), p_prev=z3.clone())
    return RegenState(
        vp=vp, pid=torch.full((N,), -1, dtype=torch.int64, device=device),
        lane_it=torch.zeros((N,), dtype=torch.int32, device=device),
        queue=torch.zeros((), dtype=torch.int64, device=device),
        out=torch.zeros((n_paths + 1, 3), device=device))


def _retire_and_refill(scene, meta, st: RegenState, n_paths: int,
                       pass0: int, family: str) -> RegenState:
    """Add finished paths' radiance to the output buffer, then issue fresh
    camera paths from the queue into every empty lane."""
    vp = st.vp
    W, H = meta.film.width, meta.film.height
    P = W * H

    # retire: each path adds once (its lane's pid is -1 after)
    done = ~vp.active & (st.pid >= 0)
    Lr = torch.where(torch.isfinite(vp.result), vp.result, 0.0)
    idx = torch.where(done, st.pid, n_paths)
    out = st.out.index_add_(0, idx, torch.where(done[:, None], Lr, 0.0))
    pid = torch.where(done, -1, st.pid)

    # refill: rank the empty lanes, issue queue ids in order
    empty = ~vp.active
    rank = torch.cumsum(empty.to(torch.int64), 0) - 1
    new_pid = st.queue + rank
    issue = empty & (new_pid < n_paths)
    queue = torch.clamp(st.queue + empty.sum(), max=n_paths)

    pix = torch.where(issue, new_pid % P, 0)
    pss = torch.where(issue, torch.div(new_pid, P, rounding_mode='floor'),
                      0) + pass0
    jit2 = lane_jitter(meta.sampler, pss, pix)
    px = (pix % W).to(torch.float32) + jit2[:, 0]
    py = torch.div(pix, W, rounding_mode='floor').to(torch.float32) \
        + jit2[:, 1]
    pos01 = torch.stack([px * (1.0 / W), py * (1.0 / H)], dim=-1)
    ray, sw = sensor_mod.sample_ray(scene, meta, pos01,
                                    lane_uniform2(pss, pix, _APERTURE_SALT))

    i1 = issue
    i3 = issue[:, None]
    fresh = dict(
        ray=Ray(torch.where(i3, ray.o, vp.ray.o),
                torch.where(i3, ray.d, vp.ray.d),
                torch.where(i1, ray.mint, vp.ray.mint),
                torch.where(i1, ray.maxt, vp.ray.maxt)),
        # the sensor weight folds into the first throughput, so a retired
        # result is already importance-weighted
        throughput=torch.where(i3, sw, vp.throughput),
        result=torch.where(i3, 0.0, vp.result),
        eta=torch.where(i1, 1.0, vp.eta),
        depth=torch.where(i1, 0, vp.depth),
        active=vp.active | i1)
    if family == 'path':
        vp = vp._replace(
            **fresh,
            prev_pdf=torch.where(i1, 1.0, vp.prev_pdf),
            prev_delta=torch.where(i1, True, vp.prev_delta),
            prev_p=torch.where(i3, ray.o, vp.prev_p))
    else:
        u_ch, smp = vp.sampler.next_1d()
        channel = torch.clamp((u_ch * 3).to(torch.int32), max=2)
        vp = vp._replace(
            **fresh, sampler=smp,
            medium_idx=torch.where(i1, meta.camera_medium, vp.medium_idx),
            channel=torch.where(i1, channel, vp.channel),
            # a stale cached hit is harmless: needs_isect forces a fresh
            # intersection before any use
            needs_isect=torch.where(i1, True, vp.needs_isect),
            em_full=torch.where(i1, True, vp.em_full),
            prev_pdf=torch.where(i1, 0.0, vp.prev_pdf),
            p_prev=torch.where(i3, ray.o, vp.p_prev))
    return RegenState(vp=vp, pid=torch.where(issue, new_pid, pid),
                      lane_it=torch.where(issue, 0, st.lane_it),
                      queue=queue, out=out)


def regen_chunk(scene, meta, st: RegenState, n_paths: int, pass0: int,
                n_iters: int, family: str, body=None):
    """``n_iters`` retire, refill and bounce iterations. Returns (state,
    pending): pending counts the unissued and live paths (0 when the
    chunk is complete), a device scalar."""
    if body is None:
        N = st.pid.shape[0]
        body = (path_mod if family == 'path' else volpath).make_body(
            scene, meta, N)
    for _ in range(n_iters):
        st = _retire_and_refill(scene, meta, st, n_paths, pass0, family)
        vp = body(st.vp)
        lane_it = st.lane_it + vp.active.to(torch.int32)
        vp = vp._replace(active=vp.active & (lane_it < LANE_ITER_CAP))
        st = st._replace(vp=vp, lane_it=lane_it)
    pending = (n_paths - st.queue) + st.vp.active.sum()
    return st, pending


def _splat_chunk(meta, out, pass0: int, spp_chunk: int, image):
    """The filtered splat of a finished chunk: for each pass, the refill's
    (pass, pixel) jitter again and the pixel-ordered splat, so the
    reconstruction is the pass loop's."""
    W, H = meta.film.width, meta.film.height
    P = W * H
    pix = torch.arange(P, dtype=torch.int64, device=out.device)
    for p in range(spp_chunk):
        jit2 = lane_jitter(meta.sampler, torch.full_like(pix, pass0 + p),
                           pix)
        image = film_mod.splat_pixel_ordered(
            meta.film, jit2, out[p * P:(p + 1) * P], image)
    return image


def render_regen(scene, meta, seed: int = 0, spp=None, ray_stats=None,
                 n_lanes: int = None, verbose: bool = False,
                 integrator: str = None):
    """A whole render through the regeneration scheduler -> (H, W, 4)
    premultiplied accumulation (the caller develops it)."""
    spp = spp or meta.spp
    family = _family(integrator or meta.integrator)
    W, H = meta.film.width, meta.film.height
    P = W * H
    dev = scene.device
    if n_lanes is None:
        # volpath takes a lane a pixel (at least 16,384). The reference
        # tuned 6,144 lanes on a TPU; on the H100 every eager iteration
        # costs its launches and walk reads whatever the width, so the
        # widest wins: hetvol_volpath 768x576, 2 spp took 11.4 s at
        # 442,368 lanes (the film), 17.8 s at 131,072, 49.3 s at 32,768
        # and 223 s at 6,144, the pass loop 13.8 s (PERF.md section 5).
        # MNT_REGEN_LANES sets the width, as in the reference (the
        # parity tests hold both packages at one width)
        width = max(16384, P)
        n_lanes = int(os.environ.get(
            'MNT_REGEN_LANES', width if family == 'volpath' else PATH_LANES))
        n_lanes = min(n_lanes, width)  # small films need no more
    spp_per_chunk = max(1, min(spp, MAX_CHUNK_PATHS // P))
    key = rng.PRNGKey(seed)
    body = (path_mod if family == 'path' else volpath).make_body(
        scene, meta, n_lanes)

    image = film_mod.new_image(meta.film, dev, scene.dtype)
    p = 0
    with torch.no_grad():
        while p < spp:
            n_pass = min(spp_per_chunk, spp - p)
            n_paths = P * n_pass
            st = _genesis(meta, rng.fold_in(key, 0x7e6e + p), n_lanes,
                          n_paths, family, dev)
            # every path at the lane cap, plus the genesis fill, the last
            # drain and the one-behind read
            max_disp = -(-n_paths // n_lanes) * \
                -(-LANE_ITER_CAP // ITERS_PER_DISPATCH) + 3
            pend_prev = None
            for _ in range(max_disp):
                st, pending = regen_chunk(scene, meta, st, n_paths, p,
                                          ITERS_PER_DISPATCH, family, body)
                if pend_prev is not None and int_on_host(pend_prev) == 0:
                    break
                pend_prev = pending
            if ray_stats is not None:
                ray_stats.append(st.vp.sampler.rays)
            image = _splat_chunk(meta, st.out, p, n_pass, image)
            p += n_pass
            if verbose:
                print(f"  regen chunk done: pass {p}/{spp}")
    return image


def regen_supported(meta, name: str, diff: bool = False) -> bool:
    """The reference's gate: a supported integrator family, a
    decomposable film sampler, the primal render (a differentiable render
    never takes the scheduler), and no spectral mode."""
    return (not diff) and _family(name) is not None \
        and meta.sampler in REGEN_SAMPLERS and not meta.spectral

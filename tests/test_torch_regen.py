"""The regeneration scheduler (``integrators/regen.py``) and its per-lane
jitter through the port against the reference on the CPU: the
``lane_jitter``/``lane_uniform2`` streams equal in bits, the jitter's
(pass, pixel) contract, whole ``MNT_REGEN=1`` renders (``volpath`` in a
homogeneous fog and in the heterogeneous grid of ``hetvol_box``, and
``path``) against the reference's regeneration renders, and the opt-in
gate and bookkeeping of ``render``.

Renders: every pixel within 1e-3 relative (1e-6 absolute) and the ray
counts equal, the reference's dispatches (``regen_chunk``, compiled at
its import) recompiled with IEEE rounding like the rest of it
(``torch_parity.ieee_reference``)."""
import functools
import os

import jax
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import sampler as jsampler
from mitsuba_nlvrl_tpu.integrators import regen as jregen

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import sampler as psampler
from mitsuba_nlvrl_tpu_torch.integrators import regen as pregen
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference

FOG = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.9}
RES, SPP = 16, 2
# a wavefront of 128 lanes for these small films (both packages read
# MNT_REGEN_LANES when they render; by default the reference takes 6,144
# volpath lanes and the port one a pixel, and both 65,536 path lanes)
LANES = '128'


@pytest.fixture(autouse=True)
def small_wavefront(monkeypatch):
    monkeypatch.setenv('MNT_REGEN_LANES', LANES)


@pytest.fixture
def regen_on(monkeypatch):
    monkeypatch.setenv('MNT_REGEN', '1')


def _u32(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize('sampler', sorted(psampler.REGEN_SAMPLERS))
def test_lane_streams_equal_reference_in_bits(sampler):
    rng = np.random.default_rng(1)
    pl = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    px = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    pl[:4] = (0, 1, 2 ** 32 - 1, 7)
    tl = torch.as_tensor(pl.astype(np.int64))
    tx = torch.as_tensor(px.astype(np.int64))
    got = psampler.lane_jitter(sampler, tl, tx).numpy()
    ref = jax.jit(lambda a, b: jsampler.lane_jitter(sampler, a, b))(pl, px)
    assert np.array_equal(_u32(got), _u32(ref))
    got = psampler.lane_uniform2(tl, tx, 0x0a9e31).numpy()
    ref = jax.jit(lambda a, b: jsampler.lane_uniform2(a, b, 0x0a9e31))(pl,
                                                                       px)
    assert np.array_equal(_u32(got), _u32(ref))
    assert psampler.REGEN_SAMPLERS == jsampler.REGEN_SAMPLERS


@pytest.mark.parametrize('sampler', sorted(psampler.REGEN_SAMPLERS))
def test_lane_jitter_decomposes(sampler):
    """The refill's scattered lanes and the splat's dense pass compute the
    same offset for the same (pass, pixel), in [0, 1), varying across
    pixels and passes."""
    n = 64
    pix = torch.arange(n)
    dense = psampler.lane_jitter(sampler, torch.full((n,), 3), pix).numpy()
    sel = [5, 0, 63, 17, 9, 33, 2]
    scat = psampler.lane_jitter(sampler, torch.full((7,), 3),
                                pix[sel]).numpy()
    assert np.array_equal(scat, dense[sel])
    assert ((dense >= 0) & (dense < 1)).all()
    assert np.unique(dense[:, 0]).size > n // 2
    nxt = psampler.lane_jitter(sampler, torch.full((n,), 4), pix).numpy()
    assert np.abs(nxt - dense).max() > 0.01


@functools.lru_cache(maxsize=None)
def _reference(kind):
    # ``path`` under the point light: a path that lands on the area
    # light samples the light's own plane, where a cosine of 0 or an ulp
    # from it (XLA's and torch's sines) decides whether a shadow ray flies
    if kind == 'hetvol':
        desc = scenes.cornell_box(
            spp=SPP, res=RES, integrator={'type': 'volpath', 'max_depth': 8},
            medium=pscenes.hetvol_medium(grid_res=16, seed=0, scale=20.0))
    else:
        desc = scenes.cornell_box(
            spp=SPP, res=RES, integrator={'type': kind, 'max_depth': 6},
            medium=FOG if kind == 'volpath' else None,
            light='area' if kind == 'volpath' else 'point')
    sj, mj, sp, mp = build_both(desc)
    stats, info = [], {}
    old = {k: os.environ.get(k) for k in ('MNT_REGEN', 'MNT_REGEN_LANES')}
    os.environ.update(MNT_REGEN='1', MNT_REGEN_LANES=LANES)
    try:
        with ieee_reference():
            real = jregen.regen_chunk
            jregen.regen_chunk = ieee_jit(
                real.__wrapped__, donate_argnums=(2,),
                static_argnames=('meta', 'n_paths', 'n_iters', 'family'))
            try:
                img = np.asarray(J.render(sj, mj, seed=0, spp=SPP,
                                          ray_stats=stats, info=info))
            finally:
                jregen.regen_chunk = real
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert info['scheduler'] == 'regen'
    return sp, mp, img, sum(float(r) for r in stats)


@pytest.mark.parametrize('kind', ['volpath', 'hetvol', 'path'])
def test_regen_render_matches_reference(kind, regen_on):
    sp, mp, img_j, rays_j = _reference(kind)
    stats, info = [], {}
    img_p = P.render(sp, mp, seed=0, spp=SPP, ray_stats=stats,
                     info=info).numpy()
    assert info['scheduler'] == 'regen' and info['passes_done'] == SPP
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert sum(float(r) for r in stats) == rays_j
    assert img_p.mean() > 0.01


def test_regen_is_opt_in(monkeypatch):
    """The pass loop stays the default; ``MNT_REGEN=1`` asks for the
    scheduler, which a sampler without a decomposable jitter, a spectral
    scene or a per-pass hook turns down."""
    monkeypatch.delenv('MNT_REGEN', raising=False)
    desc = pscenes.cornell_box(spp=1, res=4, medium=FOG,
                               integrator={'type': 'volpath'})
    sp, mp = P.build_scene(desc, device='cpu')
    info = {}
    P.render(sp, mp, seed=0, info=info)
    assert 'scheduler' not in info
    monkeypatch.setenv('MNT_REGEN', '1')
    P.render(sp, mp, seed=0, info=info)
    assert info['scheduler'] == 'regen'
    info = {}
    P.render(sp, mp, seed=0, info=info, on_pass=lambda p, dev: None)
    assert 'scheduler' not in info
    desc['sensor']['sampler']['type'] = 'multijitter'
    sp, mp = P.build_scene(desc, device='cpu')
    assert not pregen.regen_supported(mp, 'volpath')
    P.render(sp, mp, seed=0, info=info)
    assert 'scheduler' not in info
    desc = pscenes.cornell_box(spp=1, res=4)
    desc['spectral'] = True
    sp, mp = P.build_scene(desc, device='cpu')
    assert not pregen.regen_supported(mp, 'path')


def test_regen_tiny_film_counts_its_reads(regen_on, monkeypatch):
    """More lanes than paths: the queue drains at the first refill and the
    weight channel still develops every pixel. The pending count is read
    once a dispatch, one dispatch behind: here two dispatches, one
    read."""
    monkeypatch.setattr(pregen, 'ITERS_PER_DISPATCH', 16)
    desc = pscenes.cornell_box(spp=2, res=4,
                               integrator={'type': 'path', 'max_depth': 4})
    sp, mp = P.build_scene(desc, device='cpu')
    reads = []
    real = pregen.int_on_host

    def counted(x):
        reads.append(int(x))
        return real(x)
    monkeypatch.setattr(pregen, 'int_on_host', counted)
    stats = []
    img = P.render(sp, mp, seed=0, spp=2, ray_stats=stats).numpy()
    assert img.shape == (4, 4, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    assert reads == [0] and len(stats) == 1
    assert float(stats[0]) > 2 * 16

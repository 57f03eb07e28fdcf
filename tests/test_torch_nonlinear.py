"""The nonlinear medium of the port against the reference: the scene
builder's IOR grid, one bend event (``sample_nonlinear_interaction``) and
a whole bent ray (``bend_ray``), and the reference's own physical checks (a
mirage ray flattens and reflects back, a uniform grid bends nothing,
Snell's law at one cell face).

The reference runs with IEEE rounding (``torch_parity.ieee_reference``):
a bend at a total internal reflection turns on the last bit of the
reflected ray's position. With it, every lane agrees within 1e-5 (found:
within 1e-6, every count and validity equal, over 512 random rays through
the slab at 64 and at 2 IOR cells).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.medium import nonlinear as jnl
from mitsuba_nlvrl_tpu_torch.core import transform as ptr
from mitsuba_nlvrl_tpu_torch.core.ray import Ray as PRay
from mitsuba_nlvrl_tpu_torch.medium import nonlinear as pnl
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (ieee_jit, ieee_reference, jax_meta_dict,
                          scene_arrays)

TOL = 1e-5
N_RAYS = 512


def _slab(tr, top_ior=0.8, bottom_ior=1.0, res_y=64):
    """tests/test_nlvrl.py::_nl_slab_scene with either package's
    transforms."""
    return {
        'sensor': {'type': 'perspective',
                   'to_world': tr.look_at((0, 0, -3), (0, 0, 0), (0, 1, 0)),
                   'film': {'width': 8, 'height': 8,
                            'rfilter': {'type': 'box'}}},
        'integrator': {'type': 'path'},
        'shapes': [
            {'type': 'cube', 'bsdf': {'type': 'null'},
             'interior': {'type': 'nonlinear', 'sigma_t': 0.01,
                          'albedo': 0.5, 'res_x': 1, 'res_y': res_y,
                          'res_z': 1, 'top_ior': top_ior,
                          'bottom_ior': bottom_ior},
             'to_world': tr.scale((4, 1, 4))},
        ],
        'emitters': [{'type': 'constant', 'radiance': (1, 1, 1)}],
    }


def _cbox_nlvrl(pkg):
    desc = pkg.cornell_box(spp=1, res=16,
                           integrator={'type': 'vrl', 'target_vrls': 256},
                           medium=dict(pscenes.NLVRL_MEDIUM))
    desc['sensor']['film']['height'] = 8
    return desc


DESCS = {'slab': lambda pkg, tr: _slab(tr),
         'cbox_nlvrl': lambda pkg, tr: _cbox_nlvrl(pkg)}


@pytest.mark.parametrize('name', list(DESCS))
def test_builder_matches_reference(name):
    """Each package's own builder: the nonlinear medium's row (IOR
    profile and resolution slots) and its voxelised IOR grid."""
    sj, mj = J.build_scene(DESCS[name](scenes, jtr))
    sp, mp = P.build_scene(DESCS[name](pscenes, ptr), device='cpu')
    ref, port = scene_arrays(sj), scene_arrays(sp)
    for k, a in port.items():
        b = ref[k]
        assert a.shape == b.shape, k
        if k.startswith('media.nl') or a.dtype.kind in 'biu':
            assert (a == b).all(), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert port['media.nl_ior'].shape == (640 if name == 'cbox_nlvrl'
                                          else 64,)
    assert int(port['media.nl_medium']) == 0
    assert mp.medium_types == mj.medium_types == (2,)


def _both(res_y):
    sj, mj = J.build_scene(_slab(jtr, res_y=res_y))
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    return sj, mj, sp, mp


def _rays(seed):
    """Random rays with origins inside the slab (x, z in (-3.9, 3.9), y
    in (-0.99, 0.99)), as numpy (o, d, mint, maxt)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.9, 3.9, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-0.99, 0.99, N_RAYS)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.zeros(N_RAYS, np.float32),
            np.full(N_RAYS, np.inf, np.float32))


def _args(rays, jax_side: bool):
    cast = jnp.asarray if jax_side else torch.as_tensor
    ray = (JRay if jax_side else PRay)(*(cast(a) for a in rays))
    return (ray, cast(np.zeros(N_RAYS, np.int32)),
            cast(np.ones(N_RAYS, bool)))


def _close(a, b, name):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, name
    if a.dtype.kind in 'biu':
        assert (a == b).all(), name
        return
    fin = np.isfinite(a)
    assert (fin == np.isfinite(b)).all(), name
    np.testing.assert_allclose(b[fin], a[fin], rtol=TOL, atol=TOL,
                               err_msg=name)


@pytest.mark.parametrize('res_y', [64, 2])
def test_nonlinear_interaction_matches_reference(res_y):
    sj, mj, sp, mp = _both(res_y)
    rays = _rays(res_y)
    with ieee_reference():
        a = jnl.sample_nonlinear_interaction(sj, mj, *_args(rays, True))
    b = pnl.sample_nonlinear_interaction(sp, mp, *_args(rays, False))
    assert 0 < int(np.asarray(a.valid).sum()) < N_RAYS
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize('res_y', [64, 2])
def test_bend_ray_matches_reference(res_y):
    sj, mj, sp, mp = _both(res_y)
    rays = _rays(100 + res_y)
    with ieee_reference():
        a, _ = ieee_jit(jnl.bend_ray, static_argnums=(1, 5))(
            sj, mj, *_args(rays, True), 16)
    b, _ = pnl.bend_ray(sp, mp, *_args(rays, False), max_segments=16)
    assert int(np.asarray(a.count).max()) > 2
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), f)
    t = np.random.default_rng(res_y).uniform(0, 2.0, N_RAYS).astype(
        np.float32)
    _close(a.at(jnp.asarray(t)), b.at(torch.as_tensor(t)), 'at')


def _port_slab(**kw):
    return P.build_scene(_slab(ptr, **kw), device='cpu')


def _one(o, d):
    return (PRay.make(torch.tensor([o], dtype=torch.float32),
                      torch.tensor([d], dtype=torch.float32), mint=0.0),
            torch.zeros((1,), dtype=torch.int32),
            torch.ones((1,), dtype=torch.bool))


def test_nonlinear_marcher_mirage_bending():
    """A ray rising through decreasing IOR flattens and reflects back
    down without leaving the slab."""
    scene, meta = _port_slab()
    ang = math.radians(30)
    bent, _ = pnl.bend_ray(scene, meta, *_one(
        (-3.9, -0.95, 0.0), (math.cos(ang), math.sin(ang), 0.0)),
        max_segments=128)
    cnt = int(bent.count[0])
    assert cnt > 10
    dirs = bent.seg_d[0, :cnt].numpy()
    ys = bent.seg_o[0, :cnt, 1].numpy()
    assert dirs[cnt // 2, 1] < dirs[0, 1]
    assert dirs[-1, 1] < 0
    assert ys.max() < 1.0


def test_nonlinear_uniform_ior_goes_straight():
    scene, meta = _port_slab(top_ior=1.0, bottom_ior=1.0)
    bent, _ = pnl.bend_ray(scene, meta, *_one((-3.9, -0.5, 0.0),
                                              (0.8, 0.6, 0.0)),
                           max_segments=64)
    dirs = bent.seg_d[0, :int(bent.count[0])].numpy()
    assert np.abs(dirs - dirs[0]).max() < 1e-5


def test_snell_refraction_at_cell_boundary():
    """One face: sin(t1) * n1 == sin(t2) * n2."""
    scene, meta = _port_slab(top_ior=0.5, bottom_ior=1.0, res_y=2)
    ang = math.radians(20)
    nli = pnl.sample_nonlinear_interaction(
        scene, meta, *_one((0.0, -0.5, 0.0),
                           (math.sin(ang), math.cos(ang), 0.0)))
    assert bool(nli.valid[0])
    n1, n2 = float(nli.n1[0]), float(nli.n2[0])
    assert abs(math.sin(ang) * n1 - abs(float(nli.wo[0, 0])) * n2) < 1e-4

"""The double variant: the port's float64 render and gradient against the
reference's x64 ones.

The reference's double variant turns JAX's x64 on for the whole process,
so it runs once, in a subprocess (as tests/test_double.py runs it): the
12x12 Cornell box at 2 spp, built with ``desc['double']``, rendered with
IEEE rounding and one pass a dispatch, and the gradient of
sum(image * W) with respect to the BSDF parameters at 1 spp. The port
renders the very same float64 arrays (``scene_from_numpy``).

Tolerances. Where the reference names float32 (the sampler's uniforms,
the film positions, the ray count), both packages keep float32, and the
operations on those values round in float32, where torch's and XLA's sin
and cos part by an ulp; everything downstream is float64. Measured:
every pixel of the port's float64 render within 2.3e-8 relative of the
reference's x64 render, held to 1e-7, the rays equal; the port's float32
render of the same scene misses that bound (8.95e-7); the gradient
within 3.7e-8 of its largest entry, held to 1e-6. The port's float64
render agrees with its float32 render as tests/test_double.py requires
of the reference's (means within 2e-3 relative)."""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import autodiff as pad
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

torch.set_num_threads(1)   # one intra-op thread a test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SPP = 12, 2

_CHILD = r"""
import pickle, sys
sys.path.insert(0, %(repo)r); sys.path.insert(0, %(tests)r)
import jax
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
import numpy as np
import scenes
from torch_parity import ieee_jit, ieee_reference, jax_meta_dict, \
    scene_arrays
from mitsuba_nlvrl_tpu import autodiff as ad, build_scene, render
desc = scenes.cornell_box(spp=%(spp)d, res=%(res)d)
desc['double'] = True
scene, meta = build_scene(desc)
assert scene.geo.v0.dtype == jnp.float64
stats = []
with ieee_reference():
    img = np.asarray(render(scene, meta, seed=3, spp=%(spp)d,
                            ray_stats=stats, spp_per_dispatch=1))
    pm = ad.traverse(scene).keep(['bsdfs.params'])
    W = jnp.asarray(np.random.default_rng(5).standard_normal(
        (%(res)d, %(res)d, 3)))

    def loss(params):
        return jnp.sum(ad.render(scene, meta, params=params, pmap=pm,
                                 spp=1, seed=1) * W)
    g = ieee_jit(jax.grad(loss))({'bsdfs.params': scene.bsdfs.params})
with open(%(out)r, 'wb') as f:
    pickle.dump({'arrays': scene_arrays(scene), 'meta': jax_meta_dict(meta),
                 'img': img, 'rays': sum(float(r) for r in stats),
                 'grad': np.asarray(g['bsdfs.params'])}, f)
"""


@functools.lru_cache(maxsize=None)
def _reference_x64(tmp: str):
    out = os.path.join(tmp, 'x64.pkl')
    code = _CHILD % {'repo': ROOT, 'tests': os.path.join(ROOT, 'tests'),
                     'spp': SPP, 'res': RES, 'out': out}
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, 'rb') as f:
        return pickle.load(f)


def _ref(tmp_path_factory):
    return _reference_x64(str(tmp_path_factory.getbasetemp()))


def _port_x64(ref):
    return P.scene_from_numpy(ref['arrays'], ref['meta'], device='cpu')


def test_render_matches_reference_x64(tmp_path_factory):
    ref = _ref(tmp_path_factory)
    assert ref['img'].dtype == np.float64
    sp, mp = _port_x64(ref)
    assert sp.dtype == torch.float64
    for name in ('v0', 'e1', 'e2'):
        assert getattr(sp.geo, name).dtype == torch.float64
    img, _, rays = compare.render_with_passes(sp, mp, 3, SPP)
    assert img.dtype == np.float64
    rel = np.abs(img - ref['img']) / (np.abs(ref['img']) + 1e-12)
    assert rel.max() <= 1e-7, rel.max()
    assert rays == ref['rays']
    # the port's float32 render of the same scene is farther from it
    s32, m32 = P.build_scene(pscenes.cornell_box(spp=SPP, res=RES),
                             device='cpu')
    img32, _, _ = compare.render_with_passes(s32, m32, 3, SPP)
    rel32 = np.abs(img32 - ref['img']) / (np.abs(ref['img']) + 1e-12)
    assert rel32.max() > 1e-7, rel32.max()


def test_gradient_matches_reference_x64(tmp_path_factory):
    ref = _ref(tmp_path_factory)
    sp, mp = _port_x64(ref)
    pm = pad.traverse(sp).keep(['bsdfs.params'])
    leaf = sp.bsdfs.params.clone().requires_grad_(True)
    W = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (RES, RES, 3)))
    img = pad.render(sp, mp, params={'bsdfs.params': leaf}, pmap=pm, spp=1,
                     seed=1)
    assert img.dtype == torch.float64
    (img * W).sum().backward()
    g = leaf.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, ref['grad'], rtol=0,
                               atol=1e-6 * np.abs(ref['grad']).max())


def test_double_agrees_with_single():
    """The port's float64 render against its float32 render, as
    tests/test_double.py holds the reference's (same draws, same
    estimator: means within 2e-3 relative)."""
    means = {}
    for double in (False, True):
        d = pscenes.cornell_box(spp=4, res=24)
        d['double'] = double
        s, m = P.build_scene(d, device='cpu')
        img = P.render(s, m, seed=3)
        assert img.dtype == (torch.float64 if double else torch.float32)
        assert bool(img.isfinite().all())
        means[double] = float(img.mean())
    assert abs(means[True] - means[False]) < 2e-3 * abs(means[False])


def test_plain_kernel_version_in_float64():
    """The plain version takes float64 and keeps it: its hits equal a
    float64 Möller-Trumbore sweep written out in numpy in the same
    operation order, and it differs from the float32 sweep's t only at
    float32 rounding."""
    rng = np.random.default_rng(0)
    T, N = 37, 500
    v0 = rng.uniform(-1, 1, (T, 3))
    e1 = rng.uniform(-0.5, 0.5, (T, 3))
    e2 = rng.uniform(-0.5, 0.5, (T, 3))
    o = rng.uniform(-2, 2, (N, 3))
    # aimed at a point of a random triangle (or just outside it)
    k = rng.integers(0, T, N)
    ab = rng.uniform(-0.1, 0.6, (N, 2))
    d = v0[k] + ab[:, :1] * e1[k] + ab[:, 1:] * e2[k] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint, maxt = np.full(N, 1e-4), np.full(N, np.inf)
    args = [torch.as_tensor(x) for x in (v0, e1, e2, o, d, mint, maxt)]
    t, idx, u, v = kern.intersect_tris_plain(*args)
    assert t.dtype == u.dtype == v.dtype == torch.float64
    px = d[:, None, 1] * e2[None, :, 2] - d[:, None, 2] * e2[None, :, 1]
    py = d[:, None, 2] * e2[None, :, 0] - d[:, None, 0] * e2[None, :, 2]
    pz = d[:, None, 0] * e2[None, :, 1] - d[:, None, 1] * e2[None, :, 0]
    det = e1[None, :, 0] * px + e1[None, :, 1] * py + e1[None, :, 2] * pz
    with np.errstate(divide='ignore', invalid='ignore'):
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        tv = o[:, None] - v0[None]
        uu = (tv[..., 0] * px + tv[..., 1] * py + tv[..., 2] * pz) * inv
        qx = tv[..., 1] * e1[None, :, 2] - tv[..., 2] * e1[None, :, 1]
        qy = tv[..., 2] * e1[None, :, 0] - tv[..., 0] * e1[None, :, 2]
        qz = tv[..., 0] * e1[None, :, 1] - tv[..., 1] * e1[None, :, 0]
        vv = (d[:, None, 0] * qx + d[:, None, 1] * qy
              + d[:, None, 2] * qz) * inv
        tt = (e2[None, :, 0] * qx + e2[None, :, 1] * qy
              + e2[None, :, 2] * qz) * inv
    hit = (np.abs(det) > 1e-12) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) \
        & (tt >= mint[:, None]) & (tt <= maxt[:, None])
    tt = np.where(hit, tt, np.inf)
    j = np.argmin(tt, axis=1)
    best = tt[np.arange(N), j]
    ok = np.isfinite(best)
    assert ok.mean() > 0.5
    assert np.array_equal(t.numpy(), best)
    assert np.array_equal(idx.numpy()[ok], j[ok])
    assert (idx.numpy()[~ok] == -1).all()
    assert np.array_equal(u.numpy()[ok], uu[np.arange(N), j][ok])
    t_any = kern.intersect_tris_plain(*args, any_hit=True)[0]
    assert np.array_equal(t_any.numpy(), best)
    t32 = kern.intersect_tris_plain(*(a.float() for a in args))[0].numpy()
    fin = np.isfinite(t32) & ok
    np.testing.assert_allclose(t32[fin], best[fin], rtol=1e-4)

"""The port's ray-triangle sweep against the reference's Pallas kernel (run
in interpret mode) and its XLA sweep ``_scan_tris``, then the port's
intersection entry points against the reference's on scene rays.

Tolerance: idx (and every integer field) equal everywhere; floats within
2e-6 for at least 99% of the elements and within 1e-4 for all, relative
for t and absolute for the unit-scale quantities (barycentrics, positions
inside the unit-size scenes, normals, frames, uvs). Why not bit-equal: XLA's CPU backend contracts ``a * b + c``
into one fused multiply-add (jit of ``a * b - 1`` with a = b = 1 + 2**-12
gives 2**-11 + 2**-24, not the separately rounded 2**-11), while torch's
eager operations round every product. Where the Möller-Trumbore dot
products nearly cancel, that one rounding is amplified: about half of the
hits agree in every bit; over 32k random hits the 99th percentile of the
difference is 3.7e-7 relative in t and 1.3e-6 in u and v, and the worst
seen is 9.8e-6 relative in t and 3.6e-5 in u.
The port's kernel and its plain version round alike (no contraction), so
on the card they are held to equal bits instead (chip_smoke.py)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import mitsuba_nlvrl_tpu.ops.pallas.intersect_tpu as jtpu
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.ops import intersect as jisect
from mitsuba_nlvrl_tpu_torch.core.ray import Ray as PRay
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
from mitsuba_nlvrl_tpu_torch.scene.builder import icosphere_mesh

from scenes import cornell_box, sphere_scene
from torch_parity import build_both

RTOL = 2e-6        # for at least MOST of the elements
RTOL_ALL = 1e-4    # for every element
MOST = 0.99


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the reference's TPU kernel through Pallas' interpreter."""
    monkeypatch.setattr(jtpu, 'pl', types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _rays(rng, N, spread=3.0):
    o = rng.uniform(-spread, spread, (N, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(N, 1e-4, np.float32)
    maxt = np.full(N, np.inf, np.float32)
    return o, d.astype(np.float32), mint, maxt


def _random_tris(rng, T):
    v0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    return v0, e1, e2


def _icosphere_tris():
    m = icosphere_mesh(2)
    V = m.vertices[m.faces]
    return V[:, 0], V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]


def _case(name, rng):
    o, d, mint, maxt = _rays(rng, 1500)
    if name == 'random':
        tris = _random_tris(rng, 200)
    elif name == 'icosphere':
        tris = _icosphere_tris()
    elif name == 'duplicates':
        v0, e1, e2 = _random_tris(rng, 60)
        tris = tuple(np.concatenate([x, x, x[::-1]]) for x in (v0, e1, e2))
    elif name == 'empty':
        tris = tuple(np.zeros((0, 3), np.float32) for _ in range(3))
    elif name == 'degenerate':
        v0, e1, e2 = _random_tris(rng, 130)
        e2[::2] = 2.0 * e1[::2]              # zero-area triangles
        e1[1::4] = 0.0
        tris = (v0, e1, e2)
    elif name == 'maxt_below_mint':
        tris = _random_tris(rng, 100)
        maxt = np.where(np.arange(1500) % 2 == 0, -1.0, 2.5).astype(
            np.float32)
        mint = np.where(np.arange(1500) % 3 == 0, 3.0, 1e-4).astype(
            np.float32)
    else:
        raise KeyError(name)
    return tris, (o, d, mint, maxt)


CASES = ['random', 'icosphere', 'duplicates', 'empty', 'degenerate',
         'maxt_below_mint']


def _port(tris, rays, any_hit):
    out = kern.intersect_tris(*[torch.as_tensor(x) for x in tris + rays],
                              any_hit=any_hit)
    if any_hit:   # any hit computes t alone
        assert out[1:] == (None, None, None)
        return [out[0].numpy(), None, None, None]
    return [x.numpy() for x in out]


def _assert_close(ref, got, what, floor=1.0):
    """Integers equal; floats within the file's tolerances, measured
    against max(|ref|, floor)."""
    ref, got = np.asarray(ref), np.asarray(got)
    if ref.dtype.kind in 'biu':
        assert (ref == got).all(), what
        return
    assert (np.isfinite(ref) == np.isfinite(got)).all(), what
    fin = np.isfinite(ref)
    ref, got = ref[fin], got[fin]
    err = np.abs(got - ref)
    scale = np.maximum(np.abs(ref), floor)
    assert (err <= RTOL_ALL * scale).all(), (what, err.max())
    most = (err <= RTOL * scale).mean() if err.size else 1.0
    assert most >= MOST, (what, most)


def _assert_hits_equal(ref, got, any_hit):
    t_r, i_r, u_r, v_r = ref
    t_g, i_g, u_g, v_g = got
    _assert_close(t_r, t_g, 't', floor=0.0)
    if any_hit:
        return
    _assert_close(i_r, i_g, 'idx')
    _assert_close(u_r, u_g, 'u')
    _assert_close(v_r, v_g, 'v')


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('name', CASES)
def test_plain_matches_pallas_interpret(pallas_interpret, name, any_hit):
    rng = np.random.default_rng(CASES.index(name))
    tris, rays = _case(name, rng)
    o, d, mint, maxt = (jnp.asarray(x) for x in rays)
    cols = [jnp.asarray(c[:, k]) for c in tris for k in range(3)]
    ref = [np.asarray(x) for x in
           jtpu.intersect_tris(cols, o, d, mint, maxt, any_hit=any_hit)]
    got = _port(tris, rays, any_hit)
    _assert_hits_equal(ref, got, any_hit)
    if name == 'duplicates' and not any_hit:
        # every hit lands on the first copy: ties go to the lowest index
        hit = ref[1] >= 0
        assert hit.any() and (got[1][hit] < 60).all()


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('name', CASES)
def test_plain_matches_scan_tris(name, any_hit):
    rng = np.random.default_rng(100 + CASES.index(name))
    tris, rays = _case(name, rng)
    o, d, mint, maxt = (jnp.asarray(x) for x in rays)
    jray = JRay(o=o, d=d, mint=mint, maxt=maxt)
    t, i, u, v, occ = jisect._scan_tris(jray, *(jnp.asarray(x)
                                                for x in tris),
                                        any_hit, maxt)
    got = _port(tris, rays, any_hit)
    if any_hit:
        assert (np.asarray(occ) == np.isfinite(got[0])).all()
    else:
        ref = [np.asarray(x) for x in (t, i, u, v)]
        _assert_hits_equal(ref, got, any_hit)


def _scene_rays(sj, mj, rng, kind):
    from mitsuba_nlvrl_tpu import sensor as jsensor
    N = 900
    if kind == 'camera':
        pos = rng.uniform(0, 1, (N, 2)).astype(np.float32)
        ray, _ = jsensor.sample_ray(sj, mj, jnp.asarray(pos),
                                    jnp.zeros((N, 2)))
        return ray
    o = rng.uniform(-0.95, 0.95, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = rng.uniform(0.1, 3.0, N).astype(np.float32)
    return JRay(o=jnp.asarray(o), d=jnp.asarray(d),
                mint=jnp.full((N,), 1e-4, jnp.float32),
                maxt=jnp.asarray(maxt))


SCENES = {
    'cbox': lambda: cornell_box(res=16),
    'sphere': lambda: sphere_scene(res=16),
    'sphere-dielectric': lambda: sphere_scene(
        res=16, bsdf={'type': 'dielectric'}),
}


@pytest.mark.parametrize('kind', ['camera', 'inside'])
@pytest.mark.parametrize('scene_name', list(SCENES))
def test_scene_intersection_matches(scene_name, kind):
    sj, mj, sp, mp = build_both(SCENES[scene_name]())
    rng = np.random.default_rng(7)
    jray = _scene_rays(sj, mj, rng, kind)
    pray = PRay(*[torch.as_tensor(np.asarray(x)) for x in jray])

    pj = jisect.intersect_preliminary(sj, jray)
    pp = pisect.intersect_preliminary(sp, pray)
    assert np.asarray(pj.valid).any()
    for f in pj._fields:
        _assert_close(getattr(pj, f), getattr(pp, f).numpy(), f,
                      floor=0.0 if f == 't' else 1.0)

    occ_j = np.asarray(jisect.ray_test(sj, jray))
    occ_p = pisect.ray_test(sp, pray).numpy()
    assert (occ_j == occ_p).all()

    si_j = jisect.compute_si(sj, jray, pj)
    si_p = pisect.compute_si(sp, pray, pp)
    for f in si_p._fields:
        if f == 'sh_frame':
            for k in ('s', 't', 'n'):
                _assert_close(getattr(si_j.sh_frame, k),
                              getattr(si_p.sh_frame, k).numpy(),
                              f'sh_frame.{k}')
        else:
            _assert_close(getattr(si_j, f), getattr(si_p, f).numpy(), f,
                          floor=0.0 if f == 't' else 1.0)

"""The port's BSDFs and emitters against the reference's, given the same
surface interactions and the same numpy uniforms. Tolerance: integer and
boolean outputs equal; floats within 1e-5 (relative and absolute)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu import emitter as jem
from mitsuba_nlvrl_tpu import sensor as jsensor
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.ops import intersect as jisect
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch import emitter as pem
from mitsuba_nlvrl_tpu_torch.core.frame import Frame as PFrame
from mitsuba_nlvrl_tpu_torch.core.records import \
    SurfaceInteraction as PSI

from scenes import cornell_box, sphere_scene
from torch_parity import build_both

TOL = 1e-5
N = 800

SCENES = {
    'cbox-area': lambda: cornell_box(res=8, light='area'),
    'cbox-point': lambda: cornell_box(res=8, light='point'),
    'cbox-constant': lambda: cornell_box(res=8, light='constant'),
    'sphere-conductor': lambda: sphere_scene(
        res=8, bsdf={'type': 'conductor', 'eta': (0.2, 0.9, 1.1),
                     'k': (3.9, 2.4, 2.2)}),
    'sphere-dielectric': lambda: sphere_scene(
        res=8, bsdf={'type': 'dielectric', 'int_ior': 1.5}),
}


def _interactions(sj, mj, rng):
    """Reference interactions at camera-ray hits and at hits of rays
    started inside the scene (back faces, the inside of the sphere)."""
    pos = rng.uniform(0, 1, (N // 2, 2)).astype(np.float32)
    cam, _ = jsensor.sample_ray(sj, mj, jnp.asarray(pos),
                                jnp.zeros((N // 2, 2)))
    o = rng.uniform(-0.95, 0.95, (N // 2, 3)).astype(np.float32)
    d = rng.normal(size=(N // 2, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = JRay(o=jnp.concatenate([cam.o, jnp.asarray(o)]),
               d=jnp.concatenate([cam.d, jnp.asarray(d)]),
               mint=jnp.concatenate([cam.mint, jnp.full((N // 2,), 1e-4)]),
               maxt=jnp.concatenate([cam.maxt, jnp.full((N // 2,),
                                                        jnp.inf)]))
    si = jisect.ray_intersect(sj, ray)
    assert np.asarray(si.valid).mean() > 0.5
    return ray, si


def _to_port(si):
    t = {f: torch.as_tensor(np.asarray(getattr(si, f)))
         for f in PSI._fields if f != 'sh_frame'}
    frame = PFrame(*[torch.as_tensor(np.asarray(x)) for x in si.sh_frame])
    return PSI(sh_frame=frame, **t)


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind in 'biu':
        assert (a == b).all(), what
    else:
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize('name', list(SCENES))
def test_bsdf_matches(name):
    sj, mj, sp, mp = build_both(SCENES[name]())
    rng = np.random.default_rng(11)
    _, si_j = _interactions(sj, mj, rng)
    si_p = _to_port(si_j)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    wo_t, u1_t, u2_t = (torch.as_tensor(x) for x in (wo, u1, u2))

    _same(jbsdf.eval(sj, mj, si_j, jnp.asarray(wo)),
          pbsdf.eval(sp, mp, si_p, wo_t), 'eval')
    _same(jbsdf.pdf(sj, mj, si_j, jnp.asarray(wo)),
          pbsdf.pdf(sp, mp, si_p, wo_t), 'pdf')
    bs_j, w_j = jbsdf.sample(sj, mj, si_j, jnp.asarray(u1), jnp.asarray(u2))
    bs_p, w_p = pbsdf.sample(sp, mp, si_p, u1_t, u2_t)
    for f in bs_p._fields:
        _same(getattr(bs_j, f), getattr(bs_p, f), f'sample.{f}')
    _same(w_j, w_p, 'sample weight')


@pytest.mark.parametrize('name', list(SCENES))
def test_emitter_matches(name):
    sj, mj, sp, mp = build_both(SCENES[name]())
    rng = np.random.default_rng(12)
    ray_j, si_j = _interactions(sj, mj, rng)
    si_p = _to_port(si_j)
    active = rng.uniform(size=N) < 0.9
    ref_p = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    u_sel = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    act_j, act_p = jnp.asarray(active), torch.as_tensor(active)

    _same(jem.eval_hit(sj, mj, si_j, act_j),
          pem.eval_hit(sp, mp, si_p, act_p), 'eval_hit')
    _same(jem.pdf_direction(sj, mj, jnp.asarray(ref_p), si_j, act_j),
          pem.pdf_direction(sp, mp, torch.as_tensor(ref_p), si_p, act_p),
          'pdf_direction')
    d = np.asarray(ray_j.d)
    _same(jem.eval_env(sj, mj, jnp.asarray(d), act_j),
          pem.eval_env(sp, mp, torch.as_tensor(d), act_p), 'eval_env')
    _same(jem.pdf_env_direction(sj, mj, act_j, jnp.asarray(d)),
          pem.pdf_env_direction(sp, mp, act_p, torch.as_tensor(d)),
          'pdf_env_direction')
    ds_j, w_j = jem.sample_direction(sj, mj, si_j.p, jnp.asarray(u_sel),
                                     jnp.asarray(u2), act_j)
    ds_p, w_p = pem.sample_direction(sp, mp, si_p.p, torch.as_tensor(u_sel),
                                     torch.as_tensor(u2), act_p)
    for f in ds_p._fields:
        _same(getattr(ds_j, f), getattr(ds_p, f), f'sample_direction.{f}')
    _same(w_j, w_p, 'sample_direction weight')

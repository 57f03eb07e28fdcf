"""The slice as a whole: the port renders the same images as the reference
from the same seed (and its camera and film stages match on their own).

The port's RNG reproduces the reference's stream, so both trace the same
light paths; only a last-bit difference (XLA's CPU backend fuses
multiply-adds, torch rounds every product) can flip a Russian-roulette or
edge decision and send one path elsewhere. The gates
(mitsuba_nlvrl_tpu_torch/testing/compare.py): at least 99% of pixels
within 1e-3 relative, image means within 1e-3 relative, measured ray
counts within 0.1%, and the golden suite's per-pixel z-test
(tests/test_golden_suite.py::_z_test, Sidak-corrected) on at least 99% of
pixels. Found at these sizes over seeds 0, 5 and 9: every pixel within
1e-3 relative (the worst 1.5e-4 absolute), means within 3e-7 relative,
ray counts within 0.065% (Cornell box; paths trapped in the gap between
the light's back and the ceiling carry no radiance, so flips there move
the count and not the image)."""
import numpy as np
import pytest

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.testing import compare

from scenes import cornell_box, sphere_scene
from torch_parity import build_both, z_test_pass_fraction

SPP = 8

SCENES = {
    'cbox': lambda: cornell_box(spp=SPP, res=32,
                                integrator={'type': 'path',
                                            'max_depth': 8}),
    'sphere-dielectric': lambda: sphere_scene(
        spp=SPP, res=32, bsdf={'type': 'dielectric'}),
}


@pytest.mark.parametrize('seed', [0, 5])
@pytest.mark.parametrize('name', list(SCENES))
def test_render_matches_reference(name, seed):
    sj, mj, sp, mp = build_both(SCENES[name]())
    stats_j, stats_p, info = [], [], {}
    img_j = np.asarray(J.render(sj, mj, seed=seed, spp=SPP,
                                ray_stats=stats_j))
    img_p = P.render(sp, mp, seed=seed, spp=SPP, ray_stats=stats_p,
                     info=info).numpy()
    assert img_p.shape == img_j.shape == (32, 32, 3)
    assert info['passes_done'] == SPP
    rays_j = sum(float(r) for r in stats_j)
    rays_p = sum(float(r) for r in stats_p)

    # per-pass images of the same render give the per-pixel variance
    img_pp, passes, rays_pp = compare.render_with_passes(sp, mp, seed, SPP)
    assert img_pp.tobytes() == img_p.tobytes() and rays_pp == rays_p

    a = compare.agreement(img_p, img_j, passes, rays_p, rays_j)
    compare.check(a)
    # the golden suite's own z-test function gives the same verdict
    z = z_test_pass_fraction(img_p, SPP, img_j,
                             passes.var(axis=0, ddof=1), SPP)
    assert z >= compare.Z_FRACTION, (z, a)


FILTERS = ['box', 'tent', 'gaussian', 'mitchell', 'catmullrom', 'lanczos']


@pytest.mark.parametrize('rfilter', FILTERS)
def test_film_splat_matches_reference(rfilter):
    import jax.numpy as jnp
    import torch
    from mitsuba_nlvrl_tpu import film as jfilm
    from mitsuba_nlvrl_tpu.scene.types import FilmMeta as JFilm
    from mitsuba_nlvrl_tpu_torch import film as pfilm
    from mitsuba_nlvrl_tpu_torch.scene.types import FilmMeta as PFilm
    H, W = 7, 9
    rng = np.random.default_rng(FILTERS.index(rfilter))
    jitter = rng.uniform(size=(H * W, 2)).astype(np.float32)
    vals = rng.uniform(size=(H * W, 3)).astype(np.float32)
    x = np.linspace(-3.5, 3.5, 57, dtype=np.float32)
    np.testing.assert_allclose(
        pfilm.filter_eval(rfilter, torch.as_tensor(x)).numpy(),
        np.asarray(jfilm.filter_eval(rfilter, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    fj = JFilm(width=W, height=H, rfilter=rfilter)
    fp = PFilm(width=W, height=H, rfilter=rfilter)
    img_j = jfilm.splat_pixel_ordered(fj, jnp.asarray(jitter),
                                      jnp.asarray(vals), jfilm.new_image(fj))
    img_p = pfilm.splat_pixel_ordered(fp, torch.as_tensor(jitter),
                                      torch.as_tensor(vals),
                                      pfilm.new_image(fp))
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pfilm.develop(img_p).numpy(),
                               np.asarray(jfilm.develop(img_j)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('name', list(SCENES))
def test_camera_rays_match_reference(name):
    import jax
    import torch
    from mitsuba_nlvrl_tpu import sensor as jsensor
    from mitsuba_nlvrl_tpu.integrators.common import \
        film_sample_positions as jpos
    from mitsuba_nlvrl_tpu_torch import sensor as psensor
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions as ppos
    sj, mj, sp, mp = build_both(SCENES[name]())
    kj = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(4), 2))[0]
    kp = rng.split(rng.fold_in(rng.PRNGKey(4), 2))[0]
    pos_j, pos01_j = jpos(mj, kj, 2)
    pos_p, pos01_p = ppos(mp, kp, 2)
    assert np.asarray(pos_j).tobytes() == pos_p.numpy().tobytes()
    assert np.asarray(pos01_j).tobytes() == pos01_p.numpy().tobytes()
    ray_j, w_j = jsensor.sample_ray(sj, mj, pos01_j, pos01_j)
    ray_p, w_p = psensor.sample_ray(sp, mp, pos01_p, pos01_p)
    for f in ray_p._fields:
        np.testing.assert_allclose(getattr(ray_p, f).numpy(),
                                   np.asarray(getattr(ray_j, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (w_p.numpy() == np.asarray(w_j)).all()
    assert isinstance(w_p, torch.Tensor)

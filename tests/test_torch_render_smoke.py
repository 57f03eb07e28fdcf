"""The port's integration smoke tests: ``tests/test_render_smoke.py`` run
on the port (tiny procedural scenes rendered end to end on the CPU: the
Cornell box under its three lights, ``direct`` against ``path`` at
max_depth 2, the ``depth`` integrator, a sphere scene, determinism for a
seed, a white furnace)."""
import numpy as np
import torch

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.core import transform as tr
from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box, sphere_scene

torch.set_num_threads(1)   # one intra-op thread a test worker


def _render(desc, spp, seed=0):
    scene, meta = P.build_scene(desc, device='cpu')
    return P.render(scene, meta, seed=seed, spp=spp).numpy()


def _finite_positive(img):
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    assert img.mean() > 0.0


def test_cornell_box_path():
    img = _render(cornell_box(spp=4, res=24), 4)
    assert img.shape == (24, 24, 3)
    _finite_positive(img)


def test_cornell_box_point_light():
    _finite_positive(_render(cornell_box(spp=4, res=24, light='point'), 4))


def test_cornell_box_constant_env():
    img = _render(cornell_box(spp=4, res=24, light='constant'), 4)
    _finite_positive(img)
    # white furnace-ish: the interior is fairly bright
    assert img.mean() > 0.2


def test_direct_vs_path_low_bounce():
    """direct equals path with max_depth 2 on a direct-lighting scene."""
    img_d = _render(cornell_box(spp=16, res=16,
                                integrator={'type': 'direct'}), 16, seed=3)
    img_p = _render(cornell_box(spp=16, res=16, integrator={
        'type': 'path', 'max_depth': 2}), 16, seed=3)
    assert abs(img_d.mean() - img_p.mean()) / max(img_p.mean(), 1e-9) < 0.15


def test_depth_integrator():
    img = _render(cornell_box(spp=1, res=16, integrator={'type': 'depth'}),
                  1)
    # camera at z=-3.2 looking at a box of half-size 1: depths in [2, ~6]
    hit = img[img > 0]
    assert hit.size > 0
    assert hit.min() > 1.5 and hit.max() < 8.0


def test_sphere_scene_renders():
    _finite_positive(_render(sphere_scene(spp=4, res=24), 4))


def test_deterministic_given_seed():
    scene, meta = P.build_scene(cornell_box(spp=2, res=16), device='cpu')
    a = P.render(scene, meta, spp=2, seed=7).numpy()
    b = P.render(scene, meta, spp=2, seed=7).numpy()
    assert np.array_equal(a, b)


def test_white_furnace():
    """A white diffuse sphere under a constant light: the radiance equals
    the light's (energy conservation)."""
    desc = {
        'integrator': {'type': 'path', 'max_depth': 48, 'rr_depth': 64},
        'sensor': {
            'type': 'perspective', 'fov': 40.0,
            'to_world': tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0)),
            'film': {'width': 16, 'height': 16, 'rfilter': {'type': 'box'}},
            'sampler': {'type': 'independent', 'sample_count': 64}},
        'shapes': [{'type': 'sphere', 'center': (0, 0, 0), 'radius': 1.0,
                    'bsdf': {'type': 'diffuse', 'reflectance': 1.0}}],
        'emitters': [{'type': 'constant', 'radiance': (1.0, 1.0, 1.0)}],
    }
    img = _render(desc, 64)
    assert abs(img.mean() - 1.0) < 0.03, img.mean()

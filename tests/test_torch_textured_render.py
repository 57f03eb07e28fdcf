"""Renders of ROADMAP item 7 through both packages on the CPU: the
16x16, 4 spp ``cbox_textured`` (a scene file: multijitter sampler,
thin lens, checkerboard, bitmaps, the four wrapper BSDFs, a shapegroup
with two instances, a spot light) and ``env_spheres`` (stratified
sampler, envmap, directional sun, projector, grid3d and mesh_attribute
textures), and the ``direct`` and ``depth`` integrators; the scene
arrays of each equal the reference's.

Tolerances: arrays 1e-6; every pixel within 1e-3 relative (1e-6
absolute), the reference rendered with IEEE rounding
(``torch_parity.ieee_reference``: XLA's fused multiply-adds move a hit
across a checkerboard edge or a mask's opacity threshold); the ray
counts equal, but within 0.1% for ``cbox_textured``. XLA's sin and cos and torch's are not correctly
rounded and differ by an ulp on a few lanes (torch's by the host's
vector unit), and in ``cbox_textured`` the block's bottom face lies in
the floor's plane: on an AVX-512 host one camera path of pass 1 (lane
169) leaves its first diffuse bounce two ulps apart and meets that tie
at t = 0.25514594 against 0.25514597, hitting the block's back in the
reference (the path ends) and the floor in the port (one more bounce
and shadow ray: 3,484 rays against 3,482)."""
import functools

import numpy as np
import pytest

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu.scene.xml import load_file as jload
from mitsuba_nlvrl_tpu_torch.scene.xml import load_file as pload
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import ieee_reference, jax_meta_dict, scene_arrays

RES, SPP = 16, 4


def _descs(name, directory):
    """(reference description, port description) of a test scene."""
    if name == 'cbox_textured':
        path = pscenes.cbox_textured(directory, spp=SPP, res=RES)
        return jload(path), pload(path)
    if name == 'env_spheres':
        return (pscenes.env_spheres(directory, RES, RES, SPP, tr_mod=jtr),
                pscenes.env_spheres(directory, RES, RES, SPP))
    integ = {'type': name}
    return (scenes.cornell_box(spp=SPP, res=RES, integrator=integ),
            pscenes.cornell_box(spp=SPP, res=RES, integrator=integ))


@functools.lru_cache(maxsize=None)
def _case(name, directory):
    dj, dp = _descs(name, directory)
    sj, mj = J.build_scene(dj)
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=SPP, ray_stats=stats,
                                  spp_per_dispatch=1))
    return sj, mj, dp, img, sum(float(r) for r in stats)


NAMES = ('cbox_textured', 'env_spheres', 'direct', 'depth')


@pytest.mark.parametrize('name', NAMES)
def test_arrays_equal_reference(name, tmp_path_factory):
    sj, mj, dp, _, _ = _case(name, str(tmp_path_factory.getbasetemp()
                                       / name))
    sp, mp = P.build_scene(dp, device='cpu')
    ref = scene_arrays(sj)
    for k, a in scene_arrays(sp).items():
        assert k in ref, k
        b = np.asarray(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for f in ('n_tris', 'n_spheres', 'bsdf_types', 'emitter_types',
              'sensor_type', 'sampler', 'has_textures', 'has_3d_textures',
              'has_attr_textures', 'has_param_textures'):
        assert getattr(mp, f) == getattr(mj, f), f


@pytest.mark.parametrize('name', NAMES)
def test_render_matches_reference(name, tmp_path_factory):
    sj, mj, _, img_j, rays_j = _case(name, str(
        tmp_path_factory.getbasetemp() / name))
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, SPP)
    assert img_p.shape == img_j.shape == (RES, RES, 3)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    if name == 'cbox_textured':       # the floor's tie, see above
        assert abs(rays_p - rays_j) <= 1e-3 * rays_j, (rays_p, rays_j)
    else:
        assert rays_p == rays_j
    assert img_p.mean() > 0.005


def test_cbox_textured_flattens_its_instances(tmp_path):
    """The shapegroup is not drawn; each instance adds its sphere, placed
    by the instance's transform."""
    sp, mp = P.build_scene(pload(pscenes.cbox_textured(str(tmp_path), spp=1,
                                                       res=4)), device='cpu')
    assert mp.n_spheres == 3
    np.testing.assert_allclose(sp.geo.sph_center.numpy()[1:],
                               [[-0.55, -0.88, -0.45], [0.65, 0.3, 0.5]],
                               atol=1e-6)
    np.testing.assert_allclose(sp.geo.sph_radius.numpy()[1:], 0.12)

"""The port's scene builder against the reference's: every SceneData array
the port holds equals the reference build to 1e-6."""
import numpy as np
import pytest

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.testing import scenes as port_scenes

import scenes
from torch_parity import jax_meta_dict, scene_arrays

DESCS = {
    'cbox-area': lambda s: s.cornell_box(light='area'),
    'cbox-point': lambda s: s.cornell_box(light='point'),
    'cbox-constant': lambda s: s.cornell_box(light='constant'),
    'sphere-conductor': lambda s: s.sphere_scene(
        bsdf={'type': 'conductor', 'eta': (0.2, 0.9, 1.1),
              'k': (3.9, 2.4, 2.2)}),
    'sphere-dielectric': lambda s: s.sphere_scene(
        bsdf={'type': 'dielectric', 'int_ior': 1.5}),
    # tessellated shapes (the transforms are each package's own)
    'disk': lambda s: dict(s.sphere_scene(), shapes=[{
        'type': 'disk', 'bsdf': {'type': 'diffuse'},
        'to_world': s.tr.translate((0.2, 0.5, 0.1)) @ s.tr.scale(0.7),
        'emitter': {'type': 'area', 'radiance': (2.0, 3.0, 4.0)}}]),
    'cylinder': lambda s: dict(s.sphere_scene(), shapes=[{
        'type': 'cylinder', 'radius': 0.3, 'p0': (0, -0.5, 0.1),
        'p1': (0.2, 0.6, -0.1), 'bsdf': {'type': 'diffuse'},
        'face_normals': True}]),
}

META_FIELDS = ('n_tris', 'n_spheres', 'n_shapes', 'n_bsdfs', 'n_emitters',
               'bsdf_types', 'emitter_types', 'sensor_type', 'sampler',
               'spp', 'integrator', 'integrator_props')


def _assert_same(port: dict, ref: dict):
    assert port, "no arrays"
    for k, a in port.items():
        assert k in ref, k
        b = ref[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind in 'biu':
            assert (a == b).all(), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def _assert_meta(mp, mj):
    for f in META_FIELDS:
        assert getattr(mp, f) == getattr(mj, f), f
    assert (mp.film.width, mp.film.height, mp.film.rfilter) == \
        (mj.film.width, mj.film.height, mj.film.rfilter)


@pytest.mark.parametrize('name', list(DESCS))
def test_build_scene_matches_reference(name):
    sj, mj = J.build_scene(DESCS[name](scenes))
    sp, mp = P.build_scene(DESCS[name](scenes), device='cpu')
    _assert_same(scene_arrays(sp), scene_arrays(sj))
    _assert_meta(mp, mj)
    # the port's own copy of the test scenes builds the same arrays
    sq, mq = P.build_scene(DESCS[name](port_scenes), device='cpu')
    _assert_same(scene_arrays(sq), scene_arrays(sj))
    _assert_meta(mq, mj)


@pytest.mark.parametrize('name', ['cbox-area', 'sphere-dielectric'])
def test_scene_from_numpy_carries_reference_arrays(name):
    sj, mj = J.build_scene(DESCS[name](scenes))
    ref = scene_arrays(sj)
    sp, mp = P.scene_from_numpy(ref, jax_meta_dict(mj), device='cpu')
    port = scene_arrays(sp)
    _assert_same(port, ref)
    for k, a in port.items():    # carried, not rebuilt: bit-equal
        assert a.tobytes() == np.ascontiguousarray(
            ref[k], a.dtype).tobytes(), k
    _assert_meta(mp, mj)


@pytest.mark.parametrize('change', [
    ('shape', {'type': 'instance'}),
    ('bsdf', {'type': 'blendbsdf'}),
    ('bsdf', {'type': 'diffuse',
              'reflectance': {'type': 'checkerboard'}}),
    ('emitter', {'type': 'spot'}),
    ('sensor', 'thinlens'),
    ('sampler', 'stratified'),
    ('integrator', 'direct'),
    ('medium', {'type': 'homogeneous', 'sigma_t': {'type': 'checkerboard'}}),
])
def test_types_outside_the_slice_raise(change):
    what, value = change
    desc = port_scenes.cornell_box(light='area')
    if what == 'shape':
        desc['shapes'].append(dict(value, bsdf={'type': 'diffuse'}))
    elif what == 'bsdf':
        desc['shapes'][0]['bsdf'] = value
    elif what == 'emitter':
        desc['emitters'].append(value)
    elif what == 'sensor':
        desc['sensor']['type'] = value
    elif what == 'sampler':
        desc['sensor']['sampler']['type'] = value
    elif what == 'integrator':
        desc['integrator'] = {'type': value}
    else:
        desc['shapes'][0]['interior'] = value
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        P.build_scene(desc, device='cpu')

"""The port's scene builder against the reference's: every SceneData array
the port holds equals the reference build to 1e-6."""
import os

import numpy as np
import pytest
import torch

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


def _change(desc, what, value):
    """``desc`` with one part replaced: a shape added, the first shape's
    BSDF, an emitter added, the sensor or sampler type, the integrator,
    the first shape's interior medium or the whole-scene variant flag."""
    if what == 'shape':
        desc['shapes'].append(value)
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
    elif what == 'variant':
        desc[value] = True
    elif what == 'spectral':
        desc['spectral'] = True
        desc['integrator'] = {'type': value}
    else:
        desc['shapes'][0]['interior'] = value
    return desc


def _jpeg(directory) -> str:
    """A baseline JPEG (4:2:0, written by PIL)."""
    from PIL import Image
    path = os.path.join(str(directory), 'slide.jpg')
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (11, 14, 3), dtype=np.uint8)).save(path, quality=90)
    return path


@pytest.mark.parametrize('change', [
    ('variant', 'double'),
    ('bsdf', {'type': 'measured', 'filename': 'm.bsdf'}),
    ('bsdf', {'type': 'measured_polarized', 'filename': 'm.pbsdf'}),
    ('spectral', 'volpath'),
    ('bsdf', {'type': 'diffuse',
              'reflectance': {'type': 'bitmap', 'filename': 'JPEG'}}),
    ('spectral', 'vrl'),
    ('spectral', 'photonmapper'),
    ('spectral', 'volpathmis'),
])
def test_later_types_build_like_the_reference_or_raise(change, tmp_path):
    """The types of slices 10 and 12 build in the port's builder as in the
    reference's: the same arrays and meta (float64 under the double
    variant). The double variant, the measured BSDFs and a spectral
    request on the integrators other than ``path`` (where the reference
    renders its RGB transport) since slice 10; a baseline JPEG bitmap,
    which raised before slice 12, decoded to the same texels as the
    reference's PIL decodes."""
    from mitsuba_nlvrl_tpu_torch.bsdf.measured import write_tensor_file
    what, value = change
    if what == 'bsdf' and value.get('reflectance', {}).get('filename') \
            == 'JPEG':
        value = dict(value, reflectance=dict(value['reflectance'],
                                             filename=_jpeg(tmp_path)))
    elif what == 'bsdf':
        write_tensor_file(str(tmp_path / 'm.bsdf'),
                          port_scenes.measured_fields(res=8, n_theta=3))
        write_tensor_file(str(tmp_path / 'm.pbsdf'),
                          port_scenes.measured_pol_fields())
        value = dict(value, filename=str(tmp_path / value['filename']))
    sp, mp = P.build_scene(_change(port_scenes.cornell_box(light='area'),
                                   what, value), device='cpu')
    # the reference's double variant turns x64 on for the whole process
    # (tests/test_double.py runs it in a subprocess): its arrays are the
    # float32 build's, each float table cast to float64
    dj = _change(scenes.cornell_box(light='area'), what, value)
    dj.pop('double', None)
    sj, mj = J.build_scene(dj)
    port = scene_arrays(sp)
    _assert_same(port, scene_arrays(sj))
    if what == 'variant':
        assert all(a.dtype != np.float32 for a in port.values())
    _assert_meta(mp, mj)
    assert mp.spectral == (what == 'spectral')
    assert (sp.dtype == torch.float64) == (what == 'variant')


def _item7_change(s, what):
    """Each type of ROADMAP item 7 (with items 3, 4 and 5) in the Cornell
    box of package module ``s`` (its own transforms)."""
    return {
        'instance': ('shape', {
            'type': 'instance', 'to_world': s.tr.translate((0.3, -0.6, 0.2)),
            'shapegroup': {'type': 'shapegroup', 'shape': [
                {'type': 'sphere', 'radius': 0.2,
                 'bsdf': {'type': 'diffuse', 'reflectance': 0.3}},
                {'type': 'rectangle', 'bsdf': {'type': 'diffuse'},
                 'to_world': s.tr.scale(0.2)}]}}),
        'blendbsdf': ('bsdf', {'type': 'blendbsdf', 'weight': 0.3, 'bsdf': [
            {'type': 'diffuse'}, {'type': 'conductor'}]}),
        'checkerboard': ('bsdf', {'type': 'diffuse', 'reflectance': {
            'type': 'checkerboard', 'uscale': 3.0}}),
        'spot': ('emitter', {'type': 'spot', 'position': (0, 0.8, 0),
                             'direction': (0, -1, 0.2)}),
        'thinlens': ('sensor', 'thinlens'),
        'stratified': ('sampler', 'stratified'),
        'direct': ('integrator', 'direct'),
    }[what]


@pytest.mark.parametrize('what', ['instance', 'blendbsdf', 'checkerboard',
                                  'spot', 'thinlens', 'stratified',
                                  'direct'])
def test_item7_types_build(what):
    """The types that raised before ROADMAP item 7 build: the port's
    description and the reference's give the same arrays, and the
    reference's arrays carry over through ``scene_from_numpy``."""
    sj, mj = J.build_scene(_change(scenes.cornell_box(light='area'),
                                   *_item7_change(scenes, what)))
    sp, mp = P.build_scene(_change(port_scenes.cornell_box(light='area'),
                                   *_item7_change(port_scenes, what)),
                           device='cpu')
    ref = scene_arrays(sj)
    _assert_same(scene_arrays(sp), ref)
    _assert_meta(mp, mj)
    sq, mq = P.scene_from_numpy(ref, jax_meta_dict(mj), device='cpu')
    _assert_same(scene_arrays(sq), ref)
    _assert_meta(mq, mj)
    img = P.render(sq, mq, seed=0, spp=1)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0

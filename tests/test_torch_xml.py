"""The port's scene-file front end against the reference's: the XML
loader returns the same description dict (transforms as matrices within
1e-6, everything else equal), scene files build the same arrays as the
dicts they describe, and spectrum-valued emitters pack to the same RGB."""
import os

import numpy as np
import pytest

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.scene import xml as jxml
from mitsuba_nlvrl_tpu.emitter import pack_params as j_pack_emitter
from mitsuba_nlvrl_tpu_torch.emitter import pack_params as p_pack_emitter
from mitsuba_nlvrl_tpu_torch.scene import xml as pxml
from mitsuba_nlvrl_tpu_torch.scene.builder import SceneBuilder
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

from torch_parity import scene_arrays

# transforms compose in float32 matrix products, whose last bits XLA and
# numpy may round apart
TRANSFORM_ATOL = 1e-6


def assert_same_desc(p, j, path='desc'):
    """Equal description dicts; a Transform (either package's) compares
    as its matrix and inverse within TRANSFORM_ATOL."""
    if hasattr(j, 'm') and hasattr(j, 'inv'):
        assert hasattr(p, 'm') and hasattr(p, 'inv'), path
        for a, b in ((p.m, j.m), (p.inv, j.inv)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=TRANSFORM_ATOL,
                                       err_msg=path)
    elif isinstance(j, dict):
        assert isinstance(p, dict) and set(p) == set(j), \
            (path, sorted(p), sorted(j))
        for k in j:
            assert_same_desc(p[k], j[k], f'{path}.{k}')
    elif isinstance(j, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(p) == len(j), path
        for i, (a, b) in enumerate(zip(p, j)):
            assert_same_desc(a, b, f'{path}[{i}]')
    elif isinstance(j, (float, np.floating)):
        assert float(p) == float(j), (path, p, j)
    else:
        assert type(p) is type(j) and p == j, (path, p, j)


def _scene(body: str) -> str:
    return f'<scene version="2.0.0">\n{body}\n</scene>'


SENSOR = '''<sensor type="perspective">
  <float name="fov" value="45"/>
  <transform name="to_world">{t}</transform>
  <film type="hdrfilm"><integer name="width" value="8"/>
    <integer name="height" value="6"/><rfilter type="gaussian"/></film>
  <sampler type="independent"><integer name="sample_count" value="3"/></sampler>
</sensor>'''

SNIPPETS = {
    # each transform form, and nested ops composing in document order
    'lookat': SENSOR.format(t='<lookat origin="1, 2, -3" target="0, 0.5, 0" '
                              'up="0, 1, 0"/>'),
    'lookat_default_up': SENSOR.format(
        t='<lookat origin="0, 0, -4" target="0, 0, 0"/>'),
    'transform_ops': '''<shape type="rectangle">
  <transform name="to_world">
    <scale value="0.5"/><scale x="2" y="3"/>
    <rotate x="1" angle="-90"/><rotate value="0.3, 1, 0.2" angle="33"/>
    <translate x="0.1" y="-1"/><translate value="1 2 3"/>
  </transform></shape>''',
    'matrix': '''<shape type="cube"><transform name="to_world">
    <matrix value="2 0 0 1  0 0 -3 2  0 1 0 0.5  0 0 0 1"/>
    <matrix value="0 1 0  -1 0 0  0 0 1"/>
  </transform></shape>''',
    # every property tag and legacy camelCase names
    'properties': '''<integrator type="volpath">
  <integer name="maxDepth" value="7"/><boolean name="hide_emitters" value="true"/>
  <float name="rr_depth" value="3"/><string name="mode" value="x"/>
  <vector name="dir" x="0" y="1" z="0.5"/><point name="p" value="1, 2, 3"/>
</integrator>
<shape type="sphere"><point name="center" x="0.1" y="0.2" z="0.3"/>
  <float name="radius" value="0.5"/>
  <bsdf type="diffuse"><rgb name="diffuseReflectance" value="0.2, 0.4, 0.6"/></bsdf>
</shape>''',
    # spectra: within and outside emitters, uniform, triple, blackbody
    'spectra': '''<shape type="rectangle">
  <bsdf type="conductor"><spectrum name="eta" value="400:0.2, 500:0.9, 700:1.1"/>
    <spectrum name="k" value="2.5"/><spectrum name="specular_reflectance" value="0.9 0.8 0.7"/></bsdf>
  <emitter type="area"><spectrum name="radiance" value="400:0, 500:8, 600:15.6, 700:18.4"/></emitter>
</shape>
<emitter type="constant"><blackbody name="radiance" temperature="4500" scale="0.5"/></emitter>
<emitter type="point"><spectrum name="intensity" value="3"/></emitter>
<shape type="cube"><bsdf type="diffuse"><blackbody name="reflectance" temperature="6000"/></bsdf></shape>''',
    # $param substitution and <default>
    'params': '''<default name="spp" value="7"/><default name="w" value="9"/>
<sensor type="perspective"><film type="hdrfilm"><integer name="width" value="$w"/>
  <integer name="height" value="$h"/></film>
  <sampler type="$sampler"><integer name="sample_count" value="$spp"/></sampler></sensor>''',
    # ids, forward and backward <ref>s, media, named IORs
    'refs': '''<shape type="cube"><ref id="glass"/><ref name="interior" id="fog"/>
  <ref id="lamp"/></shape>
<bsdf type="dielectric" id="glass"><string name="int_ior" value="bk7"/>
  <string name="ext_ior" value="air"/></bsdf>
<medium type="homogeneous" id="fog"><float name="sigma_t" value="0.5"/>
  <phase type="hg"><float name="g" value="0.3"/></phase></medium>
<emitter type="area" id="lamp"><rgb name="radiance" value="4"/></emitter>
<shape type="rectangle"><ref id="glass"/><medium type="homogeneous" name="exterior">
  <rgb name="albedo" value="0.5, 0.6, 0.7"/></medium></shape>''',
}


@pytest.mark.parametrize('name', list(SNIPPETS))
def test_load_string_matches_reference(name):
    text = _scene(SNIPPETS[name])
    params = {'h': '5', 'sampler': 'independent'} if name == 'params' \
        else None
    assert_same_desc(pxml.load_string(text, params=params),
                     jxml.load_string(text, params=params))


def test_include_path_and_files_match_reference(tmp_path):
    """<include>, <path>, relative filenames resolved against the scene
    file and the <path> directories, and <alias>."""
    sub = tmp_path / 'parts'
    sub.mkdir()
    (sub / 'walls.xml').write_text(_scene(
        '<shape type="obj"><string name="filename" value="wall.obj"/>'
        '<bsdf type="diffuse" id="white"/></shape>'))
    (tmp_path / 'lib').mkdir()
    top = tmp_path / 'scene.xml'
    top.write_text(_scene(
        '<path value="lib"/><include filename="parts/walls.xml"/>'
        '<alias id="white" as="blanc"/>'
        '<shape type="ply"><string name="filename" value="mesh.ply"/>'
        '<ref id="blanc"/></shape>'))
    p = pxml.load_file(str(top))
    j = jxml.load_file(str(top))
    assert_same_desc(p, j)
    assert p['shapes'][0]['filename'] == str(sub / 'wall.obj')


def test_cbox_xml_builds_the_dict_routes_arrays(tmp_path):
    """cbox_xml describes cornell_box with the reference cbox.xml's light
    SPD: its arrays and meta equal the dict's, and the reference's loader
    and builder make the same arrays from the file."""
    path = pscenes.cbox_xml(str(tmp_path), spp=2, res=16)
    a_x, m_x = SceneBuilder(pxml.load_file(path)).build()
    a_d, m_d = SceneBuilder(pscenes.cornell_box(
        spp=2, res=16, integrator={'type': 'path', 'max_depth': 8},
        radiance=pscenes.cbox_light_spd())).build()
    assert m_x == m_d and set(a_x) == set(a_d)
    for k in a_d:
        assert np.array_equal(np.asarray(a_x[k]), np.asarray(a_d[k])), k
    sj, _ = J.build_scene(jxml.load_file(path))
    ref = scene_arrays(sj)
    sp, _ = P.build_scene(pxml.load_file(path), device='cpu')
    for k, a in scene_arrays(sp).items():
        assert np.array_equal(a, ref[k]), k


SPECTRA = {
    'irregular': {'type': 'irregular',
                  'value': [(400.0, 0.0), (500.0, 8.0), (600.0, 15.6),
                            (700.0, 18.4)]},
    'regular': {'type': 'regular', 'lambda_min': 420.0, 'lambda_max': 680.0,
                'values': [0.5, 2.0, 1.0, 3.0, 0.25], 'scale': 2.0},
    'blackbody': {'type': 'blackbody', 'temperature': 3200.0, 'scale': 0.7},
    'd65': {'type': 'd65', 'scale': 1.5},
}


@pytest.mark.parametrize('name', list(SPECTRA))
def test_spectrum_emitters_pack_the_references_rgb(name):
    for props in ({'type': 'area', 'radiance': SPECTRA[name]},
                  {'type': 'point', 'intensity': SPECTRA[name]}):
        code_j, params_j, spec_j = j_pack_emitter(props)
        code_p, params_p, spec_p = p_pack_emitter(props)
        assert code_p == code_j
        assert np.array_equal(np.float32(params_p), np.float32(params_j))
        # the true spectrum the spectral variant samples
        assert spec_p[:3] == spec_j[:3]
        assert np.array_equal(spec_p[3], spec_j[3])
    assert max(params_p) > 0


def test_spectral_transport_still_raises():
    """Spectral transport renders on ``path``; on the other integrators,
    where the reference renders its RGB transport, the port renders the
    same (tests/test_torch_spectral.py::test_spectral_refusals_name_item_10
    holds the images to the reference's)."""
    desc = pscenes.cornell_box(radiance=SPECTRA['blackbody'], spp=1, res=8)
    desc['spectral'] = True
    _, meta = P.build_scene(desc, device='cpu')
    assert meta.spectral
    desc['integrator'] = {'type': 'volpath'}
    s, meta = P.build_scene(desc, device='cpu')
    assert meta.spectral and meta.integrator == 'volpath'
    img = P.render(s, meta, seed=0)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.01


def test_named_iors_and_conductors_match_reference(tmp_path, monkeypatch):
    from mitsuba_nlvrl_tpu.scene import ior_data as jior
    from mitsuba_nlvrl_tpu_torch.scene import ior_data as pior
    for name in ('bk7', 'Diamond', ' water ', 'vacuum', 1.33, '1.7'):
        assert pior.lookup_ior(name) == jior.lookup_ior(name)
    with pytest.raises(KeyError):
        pior.lookup_ior('unobtainium')
    rng = np.random.default_rng(3)
    wav = np.linspace(350, 850, 41)
    for which in ('eta', 'k'):
        vals = rng.uniform(0.1, 4.0, wav.size)
        (tmp_path / f'Xy.{which}.spd').write_text(
            '# test curve\n' + ''.join(f'{w:g} {v:.6f}\n'
                                       for w, v in zip(wav, vals)))
    monkeypatch.setenv('MNT_IOR_DIR', str(tmp_path))
    monkeypatch.setattr(jior, '_SPD_DIRS', [str(tmp_path)])
    monkeypatch.setattr(jior, '_CONDUCTOR_CACHE', {})
    assert pior.conductor_rgb('Xy') == jior.conductor_rgb('Xy')
    assert pior.conductor_rgb('none') == jior.conductor_rgb('none')
    assert pior.load_spd(str(tmp_path / 'Xy.k.spd')) == \
        jior.load_spd(str(tmp_path / 'Xy.k.spd'))
    monkeypatch.setenv('MNT_IOR_DIR', str(tmp_path / 'absent'))
    assert pior.conductor_rgb('Au') is None

"""The port's directional, spot, envmap and projector lights against the
reference's: ``sample_direction`` toward 4,096 random reference points,
``eval_env`` and ``pdf_env_direction`` on random escaping directions,
and ``sample_ray`` (the light pass's emission rays), each light alone
and all of them with an area light in one scene; the envmap's tables
(from an EXR, and the procedural sky that stands in for a missing file).

Tolerances: packed rows and the envmap's tables equal; sampled
positions, directions, pdfs and weights 1e-5 relative with an absolute
floor of 1e-5 of the largest value (sin, cos and atan2, which the two
libraries round apart in the last bit, feed the envmap's and the spot's
directions); the envmap's radiance and density at a direction 1e-4 (a
last-bit difference of the direction moves its bilinear lookup across a
texel of a bright sun). Where an envmap is sampled, those bounds hold on
99.9% of the lanes and 1e-3 on all: the hierarchical warp's inverse of a
nearly constant cell magnifies last-bit differences
(``tests/test_torch_distr.py``). Picks and delta flags equal. The
reference runs op by op (eagerly), without XLA's fused multiply-adds."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import emitter as jem
from mitsuba_nlvrl_tpu_torch import emitter as pem
from mitsuba_nlvrl_tpu_torch.scene import builder as pbuilder
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import jax_meta_dict, scene_arrays

RTOL = 1e-5
N = 4096


@functools.lru_cache(maxsize=None)
def _sky(directory: str) -> str:
    path = f'{directory}/sky.exr'
    pscenes.sky_exr(path, res=(64, 32))
    return path


def _lights(sky):
    tr = scenes.tr
    return {
        'directional': [{'type': 'directional', 'direction': (0.3, -1, 0.2),
                         'irradiance': (2.0, 1.5, 1.0)}],
        'spot': [{'type': 'spot', 'position': (0.2, 2.0, -0.5),
                  'direction': (-0.1, -1, 0.3), 'intensity': 5.0,
                  'cutoff_angle': 30.0, 'beam_width': 15.0}],
        'envmap': [{'type': 'envmap', 'filename': sky, 'scale': 1.5,
                    'to_world': tr.rotate((0, 1, 0), 40)}],
        'envmap_missing': [{'type': 'envmap', 'filename': 'absent.exr'}],
        'projector': [{'type': 'projector', 'fov': 35.0, 'scale': 2.0,
                       'irradiance': {'type': 'checkerboard', 'uscale': 5.0,
                                      'vscale': 5.0},
                       'to_world': tr.look_at((1.0, 2.0, -2.0), (0, 0.3, 0),
                                              (0, 1, 0))}],
        'all': [{'type': 'directional', 'direction': (0.3, -1, 0.2)},
                {'type': 'spot', 'position': (0.2, 2.0, -0.5),
                 'direction': (0, -1, 0)},
                {'type': 'envmap', 'filename': sky},
                {'type': 'projector',
                 'to_world': tr.look_at((1.0, 2.0, -2.0), (0, 0.3, 0),
                                        (0, 1, 0))}],
    }


def _scene(name, sky):
    d = scenes.sphere_scene(spp=1, res=4)
    d['emitters'] = _lights(sky)[name]
    if name == 'all':
        d['shapes'].append({'type': 'rectangle', 'bsdf': {'type': 'diffuse'},
                            'emitter': {'type': 'area', 'radiance': 3.0},
                            'to_world': scenes.tr.translate((0, 2.5, 0))
                            @ scenes.tr.rotate((1, 0, 0), 90)})
    sj, mj = J.build_scene(d)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    return sj, mj, sp, mp


def _close(got, ref, name, rtol=RTOL, warped=False):
    """Within ``rtol`` (floor: rtol of the largest value); with ``warped``
    on 99.9% of the lanes and within 1e-3 on all."""
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    if warped:
        err = np.abs(got - ref) - rtol * (np.abs(ref) + scale)
        lanes = (err <= 0).reshape(len(ref), -1).all(1)
        assert lanes.mean() >= 0.999, (name, lanes.mean())
        rtol = 1e-3
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ref_p = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    u_sel = rng.uniform(0, 1, N).astype(np.float32)
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    u3 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [(jnp.asarray(x), torch.from_numpy(x))
            for x in (ref_p, u_sel, u2, u3, d)]


LIGHTS = ('directional', 'spot', 'envmap', 'envmap_missing', 'projector',
          'all')


@pytest.mark.parametrize('name', LIGHTS)
def test_sample_direction_matches_reference(name, tmp_path_factory):
    sj, mj, sp, mp = _scene(name, _sky(str(tmp_path_factory.getbasetemp())))
    (p_j, p_p), (s_j, s_p), (u_j, u_p), _, _ = _inputs(1)
    act_j, act_p = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    ds_j, w_j = jem.sample_direction(
        sj, mj, p_j, s_j, u_j, act_j)
    ds_p, w_p = pem.sample_direction(sp, mp, p_p, s_p, u_p, act_p)
    for f in ('delta', 'emitter_idx'):
        assert (getattr(ds_p, f).numpy()
                == np.asarray(getattr(ds_j, f))).all(), f
    warped = name in ('envmap', 'all')
    for f in ('p', 'n', 'd', 'dist', 'pdf'):
        _close(getattr(ds_p, f), getattr(ds_j, f), f, warped=warped)
    _close(w_p, w_j, 'weight', rtol=1e-4 if 'envmap' in name or
           name == 'all' else RTOL, warped=warped)
    assert float(w_p.abs().sum()) > 0


@pytest.mark.parametrize('name', ['envmap', 'envmap_missing', 'all'])
def test_environment_eval_and_pdf_match_reference(name, tmp_path_factory):
    sj, mj, sp, mp = _scene(name, _sky(str(tmp_path_factory.getbasetemp())))
    *_, (d_j, d_p) = _inputs(2)
    act_j, act_p = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    f_eval = jem.eval_env
    f_pdf = jem.pdf_env_direction
    _close(pem.eval_env(sp, mp, d_p, act_p), f_eval(sj, mj, d_j, act_j),
           'eval_env', rtol=1e-4)
    _close(pem.pdf_env_direction(sp, mp, act_p, d_p),
           f_pdf(sj, mj, act_j, d_j), 'pdf_env_direction', rtol=1e-4)


@pytest.mark.parametrize('name', LIGHTS)
def test_sample_ray_matches_reference(name, tmp_path_factory):
    sj, mj, sp, mp = _scene(name, _sky(str(tmp_path_factory.getbasetemp())))
    _, (s_j, s_p), (u_j, u_p), (v_j, v_p), _ = _inputs(3)
    act_j, act_p = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    ray_j, w_j, e_j, n_j = jem.sample_ray(
        sj, mj, s_j, u_j, v_j, act_j)
    ray_p, w_p, e_p, n_p = pem.sample_ray(sp, mp, s_p, u_p, v_p, act_p)
    assert (e_p.numpy() == np.asarray(e_j)).all()
    warped = name in ('envmap', 'all')
    _close(ray_p.o, ray_j.o, 'o', warped=warped)
    _close(ray_p.d, ray_j.d, 'd', warped=warped)
    _close(n_p, n_j, 'n', warped=warped)
    _close(w_p, w_j, 'weight', rtol=1e-4 if 'envmap' in name or
           name == 'all' else RTOL, warped=warped)


def test_envmap_tables_equal_reference(tmp_path):
    """The envmap's texels and warp tables, from a file and from the
    procedural sky of a missing one, are the reference's in bits."""
    for name in ('envmap', 'envmap_missing'):
        sj, _ = J.build_scene(dict(scenes.sphere_scene(spp=1, res=4),
                                   emitters=_lights(_sky(str(tmp_path)))[
                                       name]))
        ref = scene_arrays(sj)
        d = pscenes.sphere_scene(spp=1, res=4)
        d['emitters'] = [dict(_lights(_sky(str(tmp_path)))[name][0],
                              to_world=pscenes.tr.rotate((0, 1, 0), 40))] \
            if name == 'envmap' else _lights(None)[name]
        arrays, _ = pbuilder.SceneBuilder(d).build()
        keys = [k for k in arrays if k.startswith('emitters.env')]
        assert len(keys) > 6, keys
        for k in keys:
            np.testing.assert_allclose(arrays[k], ref[k], rtol=0,
                                       atol=1e-6 if 'to_world' in k else 0,
                                       err_msg=k)
    assert pbuilder._procedural_sky().tobytes() == \
        np.asarray(ref['emitters.env_map']).tobytes()


@pytest.mark.parametrize('name', ['directional', 'spot', 'envmap',
                                  'projector'])
def test_pack_rows_match_reference(name, tmp_path):
    props = _lights(_sky(str(tmp_path)))[name][0]
    props = dict(props, to_world=pscenes.tr.look_at(
        (1.0, 2.0, -2.0), (0, 0.3, 0), (0, 1, 0))) \
        if name == 'projector' else props
    code_j, row_j, spec_j = jem.pack_params(props)
    code_p, row_p, spec_p = pem.pack_params(props)
    assert code_p == code_j
    np.testing.assert_allclose(np.float32(row_p), np.float32(row_j),
                               rtol=0, atol=1e-6)
    assert spec_p == spec_j


def test_env_emitter_idx_matches_reference(tmp_path):
    """The environment emitter's row (the first constant light's) that the
    spectral integrators read."""
    d = scenes.sphere_scene(spp=1, res=4)
    d['emitters'] = [{'type': 'point'}, {'type': 'constant'},
                     {'type': 'constant', 'radiance': 2.0}]
    sj, mj = J.build_scene(d)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    assert int(pem.env_emitter_idx(sp, mp)) == int(
        jem.env_emitter_idx(sj, mj)) == 1

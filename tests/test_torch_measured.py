"""The port's measured BSDF (``bsdf/measured.py``) against the reference's:
the tensor container, the warps, ``sample``/``eval``/``pdf`` lane by lane
on a synthesized isotropic material (with the jacobian) and an
anisotropic one reduced by symmetry 2, and the Cornell box with a block
of each rendered through both packages.

Tolerances. The container and the warp tables: equal in bits. ``eval``
and ``pdf``: 1e-6 of the largest value. ``sample``: the warps' elevation
goes through asin and the azimuth through atan2, and torch's and XLA's
float32 transcendentals part by an ulp on some lanes; a lane whose warp
position sits near a cell edge or a flat density magnifies that ulp.
Sampled directions within 2e-4 absolute on every lane and 1e-5 relative
on 97% of them; the pdf and the weight within 5e-4 relative on every
lane and 1e-5 relative on 98%. The render: every pixel within 1e-3
relative, the rays within ``compare.RAYS_RTOL`` (the reference runs with
IEEE rounding and one pass a dispatch)."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
from test_measured import _synth_fields
from torch_parity import build_both, ieee_reference, scene_arrays

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.bsdf import measured as jmeas
from mitsuba_nlvrl_tpu_torch.bsdf import measured as pmeas
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

torch.set_num_threads(1)   # one intra-op thread a test worker

N = 4096
MATERIALS = {'iso': dict(res=16, n_theta=5),
             'aniso': dict(res=16, n_theta=5, alpha=0.25, n_phi=5)}


def _hemi(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.02
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_synthesized_fields_are_the_reference_tests():
    """The port's synthesized isotropic material is the JAX tests' own."""
    a = pscenes.measured_fields(res=8, n_theta=3)
    b = _synth_fields(res=8, n_theta=3)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_tensor_file_round_trip(tmp_path, writer):
    """Either package reads what the other writes, dtypes and bits."""
    fields = pscenes.measured_fields(**MATERIALS['aniso'])
    path = str(tmp_path / 'm.bsdf')
    (pmeas if writer == 'port' else jmeas).write_tensor_file(path, fields)
    with open(path, 'rb') as f:
        raw = f.read()
    other = str(tmp_path / 'o.bsdf')
    (jmeas if writer == 'port' else pmeas).write_tensor_file(other, fields)
    with open(other, 'rb') as f:
        assert f.read() == raw
    for reader in (pmeas, jmeas):
        back = reader.read_tensor_file(path)
        assert set(back) == set(fields)
        for k in fields:
            assert back[k].dtype == fields[k].dtype, k
            assert np.array_equal(back[k], fields[k]), k


@functools.lru_cache(maxsize=None)
def _material(name):
    f = pscenes.measured_fields(**MATERIALS[name])
    return jmeas.load_fields(f), pmeas.load_fields(f)


@pytest.mark.parametrize('name', list(MATERIALS))
def test_warp_tables_equal_in_bits(name):
    (dj, mj), (dp, mp) = _material(name)
    assert tuple(mp) == tuple(mj)
    for w in dj._fields:
        a, b = getattr(dj, w), getattr(dp, w)
        for f in ('data', 'marg_cdf', 'cond_cdf'):
            assert getattr(b, f).numpy().tobytes() == \
                np.asarray(getattr(a, f)).tobytes(), (w, f)
        assert len(a.param_values) == len(b.param_values)
        for x, y in zip(a.param_values, b.param_values):
            assert y.numpy().tobytes() == np.asarray(x).tobytes()


def _share(got, ref, rtol, atol=0.0):
    return float((np.abs(got - ref) <= rtol * np.abs(ref) + atol).mean())


@pytest.mark.parametrize('name', list(MATERIALS))
def test_sample_eval_pdf_lane_by_lane(name):
    (dj, mj), (dp, mp) = _material(name)
    rng = np.random.default_rng(1)
    wi, wo = _hemi(rng, N), _hemi(rng, N)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    T = torch.from_numpy
    for f_j, f_p in ((jmeas.eval, pmeas.eval), (jmeas.pdf, pmeas.pdf)):
        a = np.asarray(f_j(dj, mj, jnp.asarray(wi), jnp.asarray(wo)))
        b = f_p(dp, mp, T(wi), T(wo)).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-6 * float(np.abs(a).max()))
        assert (a > 0).mean() > 0.3
    wo_j, pdf_j, w_j = (np.asarray(x) for x in jmeas.sample(
        dj, mj, jnp.asarray(wi), jnp.asarray(u)))
    wo_p, pdf_p, w_p = (x.numpy() for x in pmeas.sample(dp, mp, T(wi),
                                                        T(u)))
    np.testing.assert_allclose(wo_p, wo_j, rtol=0, atol=2e-4)
    assert _share(wo_p, wo_j, 1e-5, 1e-7) >= 0.97
    for got, ref in ((pdf_p, pdf_j), (w_p, w_j)):
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-7)
        assert _share(got, ref, 1e-5, 1e-7) >= 0.98
    assert (pdf_j > 0).mean() > 0.5


def _measured_box(pkg_scenes, res=8, spp=2):
    """The JAX tests' Cornell box (``pkg_scenes`` of either package) at
    max_depth 3 with a block of the anisotropic material (the reference's
    compile of one more material costs some 20 s; the isotropic one is
    held lane by lane above and rendered from its file below)."""
    tr = pkg_scenes.tr
    d = pkg_scenes.cornell_box(spp=spp, res=res,
                               integrator={'type': 'path', 'max_depth': 3})
    d['shapes'].append({
        'type': 'cube', 'to_world': tr.translate((0.4, -0.7, -0.25))
        @ tr.rotate((0, 1, 0), -18) @ tr.scale((0.4, 0.3, 0.4)),
        'bsdf': {'type': 'measured',
                 '_fields': pscenes.measured_fields(**MATERIALS['aniso'])}})
    return d


@functools.lru_cache(maxsize=None)
def _reference_render():
    sj, mj, sp, mp = build_both(_measured_box(scenes))
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=2, ray_stats=stats,
                                  spp_per_dispatch=1))
    return sj, sp, mp, img, sum(float(r) for r in stats)


def test_measured_render_matches_reference():
    """The block renders through both packages: every pixel within 1e-3,
    the rays within RAYS_RTOL."""
    _, sp, mp, img_j, rays_j = _reference_render()
    assert tuple(mp.measured_meta[0]) == (False, True, 2)
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert abs(rays_p - rays_j) <= compare.RAYS_RTOL * rays_j
    assert img_p.mean() > 0.01


def test_port_build_equals_reference_arrays(tmp_path):
    """The port's builder makes the reference's arrays from the same
    description, and from the files ``cbox_measured`` writes (the XML
    route: its blocks' tables equal those of the fields)."""
    sj = _reference_render()[0]
    sq, mq = P.build_scene(_measured_box(pscenes), device='cpu')
    ref = scene_arrays(sj)
    got = scene_arrays(sq)
    assert set(k for k in ref if k.startswith('measured')) == \
        set(k for k in got if k.startswith('measured'))
    for k, a in got.items():
        assert np.array_equal(np.asarray(a), np.asarray(ref[k])), k
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    path = pscenes.cbox_measured(str(tmp_path), spp=1, res=8, max_depth=3)
    assert os.path.exists(os.path.join(str(tmp_path), 'aniso.bsdf'))
    sx, mx = P.build_scene(load_file(path), device='cpu')
    assert [tuple(x) for x in mx.measured_meta] == [
        (True, True, 1), (False, True, 2)]
    img = P.render(sx, mx, seed=0)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.01

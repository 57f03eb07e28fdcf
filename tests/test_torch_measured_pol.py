"""The port's measured polarized pBRDF (``bsdf/measured_pol.py``) against
the reference's: the ``.pbsdf`` container, the unpolarized arms and the
polarized Mueller eval lane by lane on a synthesized polarizing and
depolarizing material, and the Cornell box with a sphere of it rendered
through both packages under ``path`` and under ``stokes``.

Tolerances. ``pdf``: equal in bits. ``eval``, ``sample`` (directions,
pdfs, weights): 1e-5 of the largest value; the Mueller eval 1e-5 of
its largest entry on 99.8% of the entries and 5e-4 on all (the
Stokes-frame rotations go through torch's and XLA's float32 sin, cos and
atan2, which part by an ulp; a few lanes whose in and out directions
nearly coincide turn their reference axes on that ulp). The renders: every pixel within 1e-3
relative of the reference's (absolute 1e-6 where the Stokes component is
near zero), the rays within ``compare.RAYS_RTOL``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
from test_measured_pol import _synth_pol_fields
from torch_parity import build_both, ieee_reference, scene_arrays

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.bsdf import measured as jmeas
from mitsuba_nlvrl_tpu.bsdf import measured_pol as jmp
from mitsuba_nlvrl_tpu_torch.bsdf import measured as pmeas
from mitsuba_nlvrl_tpu_torch.bsdf import measured_pol as pmp
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

torch.set_num_threads(1)   # one intra-op thread a test worker

N = 4096
KINDS = ('polarizing', 'depolarizing')


def _hemi(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize('kind', KINDS)
def test_fields_file_and_grid(tmp_path, kind):
    """The port's synthesized fields are the JAX tests'; the file the port
    writes loads in both packages to the same grid; a malformed M is
    refused by both."""
    fields = pscenes.measured_pol_fields(kind)
    ref = _synth_pol_fields(kind)
    for k in fields:
        assert np.array_equal(fields[k], ref[k]), k
    path = str(tmp_path / 'p.pbsdf')
    pmeas.write_tensor_file(path, fields)
    dj, dp = jmp.load(path), pmp.load(path)
    for f in dj._fields:
        assert getattr(dp, f).numpy().tobytes() == \
            np.asarray(getattr(dj, f)).tobytes(), f
    bad = dict(fields, M=fields['M'][:, :, :, :1])
    for mod in (jmp, pmp):
        with pytest.raises(ValueError):
            mod.load_fields(bad)


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize('wavelength', [-1.0, 550.0])
@pytest.mark.parametrize('kind', KINDS)
def test_arms_lane_by_lane(kind, wavelength):
    f = pscenes.measured_pol_fields(kind)
    dj, dp = jmp.load_fields(f), pmp.load_fields(f)
    rng = np.random.default_rng(2)
    wi, wo = _hemi(rng, N), _hemi(rng, N)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, N).astype(np.float32)
    P_ = np.zeros((N, 20), np.float32)
    P_[:, 1], P_[:, 2] = 0.3, wavelength
    J_ = [jnp.asarray(x) for x in (P_, wi, wo, u1, u)]
    T_ = [torch.from_numpy(x) for x in (P_, wi, wo, u1, u)]
    assert pmp.pdf(*T_[:3]).numpy().tobytes() == \
        np.asarray(jmp.pdf(*J_[:3])).tobytes()
    _close(pmp.eval(dp, *T_[:3]).numpy(), jmp.eval(dj, *J_[:3]), 1e-5,
           'eval')
    for a, b, what in zip(jmp.sample(dj, J_[0], J_[1], J_[3], J_[4]),
                          pmp.sample(dp, T_[0], T_[1], T_[3], T_[4]),
                          ('wo', 'pdf', 'weight')):
        _close(b.numpy(), a, 1e-5, what)
    for radiance in (True, False):
        a = jmp.eval_mueller_world_local(dj, *J_[:3], radiance)
        b = pmp.eval_mueller_world_local(dp, *T_[:3], radiance)
        b, a = b.numpy(), np.asarray(a)
        _close(b, a, 5e-4, f'mueller radiance={radiance}')
        scale = float(np.abs(a).max())
        assert (np.abs(b - a) <= 1e-5 * scale).mean() >= 0.998


def _pol_box(pkg_scenes, integrator):
    d = pkg_scenes.cornell_box(spp=2, res=8, integrator=integrator)
    d['shapes'].append({'type': 'sphere', **pscenes.MEASURED_POL_SPHERE,
                        'bsdf': {'type': 'measured_polarized',
                                 '_fields': pscenes.measured_pol_fields(),
                                 'alpha_sample': 0.3}})
    return d


INTEGRATORS = {
    'path': {'type': 'path', 'max_depth': 3},
    'stokes': {'type': 'stokes', 'component': 1,
               'integrator': {'type': 'path', 'max_depth': 3}},
}


@functools.lru_cache(maxsize=None)
def _reference(which):
    sj, mj, sp, mp = build_both(_pol_box(scenes, INTEGRATORS[which]))
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=2, ray_stats=stats,
                                  spp_per_dispatch=1))
    return sj, sp, mp, img, sum(float(r) for r in stats)


@pytest.mark.parametrize('which', list(INTEGRATORS))
def test_render_matches_reference(which):
    sj, sp, mp, img_j, rays_j = _reference(which)
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert abs(rays_p - rays_j) <= compare.RAYS_RTOL * rays_j
    assert np.abs(img_p).max() > 0.01
    # the port's own build of the description makes the same arrays
    sq, _ = P.build_scene(_pol_box(pscenes, INTEGRATORS[which]),
                          device='cpu')
    ref = scene_arrays(sj)
    for k, a in scene_arrays(sq).items():
        assert np.array_equal(np.asarray(a), np.asarray(ref[k])), k

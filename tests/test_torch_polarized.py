"""The port's polarized transport against the reference's on the CPU: the
optical elements' scalar arms (packing, the attenuator sample, the
straight-through transmission) and the polarized BSDF layer's Mueller
weights (``eval_pol``, ``sample_pol``, the elements and ``pplastic`` on
their own) on the lanes of the polarized box
(``tests/test_torch_stokes.py`` renders it).

Tolerances: rows and scalar arms exact; Mueller matrices within 1e-5 of
each matrix's largest entry (``eval_pol`` and the elements: 1.0e-6 at
most measured, the rotations into the Stokes frames chain sines,
cosines and 4x4 products); ``sample_pol``'s weights and pplastic's
eval within 3e-4 (1.4e-4 and 5.5e-5 measured: a grazing sampled
direction divides by a small pdf, and pplastic's refracted cosine is
the root of a difference of near numbers); pplastic is held off
grazing incidence (cos 0.02 and above), where the refracted ray leaves at the inner critical
angle and the transmitted cosine is the root of a vanishing difference
in either package. The reference runs under ``ieee_reference``."""
import functools

import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu.bsdf import polarized as jpol
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.ops import intersect as jisect

from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch.bsdf import polarized as ppol
from mitsuba_nlvrl_tpu_torch.scene.types import BSDF_TYPES
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference, port_si

N = 2048
T = torch.as_tensor
RES, SPP = 16, 2
ELEMENTS = ('polarizer', 'retarder', 'circular')


def _close(a, b, rtol=1e-4, atol=1e-5, what=''):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _close_mueller(a, b, what='', tol=1e-5):
    """Mueller matrices within ``tol`` of each matrix's largest entry."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = np.abs(b).max(axis=(-1, -2), keepdims=True)
    bad = np.abs(a - b) > tol * scale + 1e-7
    assert not bad.any(), (what, int(bad.sum()),
                           float(np.abs(a - b)[bad].max()))


@pytest.mark.parametrize('props', [
    {'type': 'polarizer', 'theta': 30.0,
     'transmittance': (0.9, 0.8, 0.7)},
    {'type': 'retarder', 'theta': 45.0, 'delta': 60.0},
    {'type': 'circular', 'left_handed': True},
    {'type': 'circular'},
])
def test_element_rows_match_reference(props):
    code_p, flags_p, row_p = pbsdf.pack_params(props)
    code_j, flags_j, row_j = jbsdf.pack_params(props)
    assert (code_p, flags_p) == (code_j, flags_j)
    assert np.array_equal(np.float32(row_p), np.float32(row_j))


def _box(pkg):
    desc = pkg.cornell_box(spp=SPP, res=RES,
                           integrator=pscenes.stokes_integrator(1, 6))
    return pscenes.dress_polarized(desc, jtr)


@functools.lru_cache(maxsize=None)
def _case():
    """The polarized box in both packages and the reference's hits of
    seeded rays from the camera's side (the panes, the sphere, the
    blocks and the walls)."""
    sj, mj, sp, mp = build_both(_box(scenes))
    rng = np.random.default_rng(1)
    o = np.tile(np.float32([[0.0, 0.0, -3.2]]), (N, 1))
    tgt = rng.uniform(-0.95, 0.95, (N, 3)).astype(np.float32)
    tgt[:, 2] = rng.uniform(-0.95, 1.0, N)
    # a quarter of the rays aim at the rough block behind the panes
    tgt[: N // 4] = np.float32([0.05, -0.7, 0.45]) \
        + rng.uniform(-0.12, 0.12, (N // 4, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    inf = np.full(N, np.inf, np.float32)
    zero = np.zeros(N, np.float32)
    with ieee_reference():
        si_j = ieee_jit(lambda s, r: jisect.ray_intersect(s, r))(
            sj, JRay(o, d, zero, inf))
    return sj, mj, sp, mp, si_j


@functools.lru_cache(maxsize=None)
def _lanes():
    """Seeded directions and numbers on ``_case``'s lanes, and the
    reference's scalar sample, straight-through transmission, ``eval_pol``
    and ``sample_pol`` there, from one compiled function."""
    sj, mj, sp, mp, si_j = _case()
    rng = np.random.default_rng(3)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2])
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)

    def ref(s, si, w, a, b):
        return (jbsdf.sample(s, mj, si, a, b),
                jbsdf.eval_null_transmission(s, mj, si),
                jpol.eval_pol(s, mj, si, w), jpol.sample_pol(s, mj, si, a, b))
    with ieee_reference():
        out = ieee_jit(ref)(sj, si_j, wo, u1, u2)
    return wo, u1, u2, out


def test_elements_attenuate_and_pass_through():
    """The scalar arms: a null pass-through weighted by slots 0:3 when
    sampled, and the same attenuation for straight-through rays."""
    sj, mj, sp, mp, si_j = _case()
    wo, u1, u2, ((bs_j, w_j), tr_j, _, _) = _lanes()
    si_p = port_si(si_j)
    btype = np.asarray(sj.bsdfs.type)[np.asarray(si_j.bsdf_idx)]
    on_el = np.isin(btype, [BSDF_TYPES[t] for t in ELEMENTS])
    assert on_el.sum() > 20
    bs_p, w_p = pbsdf.sample(sp, mp, si_p, T(u1), T(u2))
    assert bs_p.null.numpy()[on_el].all() and bs_p.delta.numpy()[on_el].all()
    _close(w_p.numpy()[on_el], np.asarray(w_j)[on_el], 0, 0)
    _close(pbsdf.eval_null_transmission(sp, mp, si_p), tr_j, 0, 0)


@pytest.mark.parametrize('what', ['eval_pol', 'sample_pol'])
def test_eval_pol_and_sample_pol_match_reference(what):
    """The world-frame Mueller weights on the box's lanes, every aware type
    among them (radiance transport, as the integrators use them)."""
    sj, mj, sp, mp, si_j = _case()
    wo, u1, u2, (_, _, M_eval_j, (bs_j, M_j)) = _lanes()
    si_p = port_si(si_j)
    if what == 'eval_pol':
        got = ppol.eval_pol(sp, mp, si_p, T(wo))
        assert got.shape == (N, 3, 4, 4)
        _close_mueller(got, M_eval_j, 'eval_pol')
    else:
        bs_p, M_p = ppol.sample_pol(sp, mp, si_p, T(u1), T(u2))
        live = np.asarray(bs_j.pdf) > 0
        assert (bs_p.pdf.numpy() > 0).tolist() == live.tolist()
        _close_mueller(M_p.numpy()[live], np.asarray(M_j)[live],
                       'sample_pol', tol=3e-4)
    btype = np.asarray(sj.bsdfs.type)[np.asarray(si_j.bsdf_idx)]
    for t in ELEMENTS + ('dielectric', 'conductor', 'roughconductor',
                         'pplastic'):
        assert (btype == BSDF_TYPES[t]).any(), t


def test_element_and_pplastic_mueller_match_reference():
    """The optical elements' straight-through Mueller matrix and the
    two-lobe pplastic eval on seeded rows and directions."""
    rng = np.random.default_rng(5)
    Pr = np.zeros((N, 20), np.float32)
    Pr[:, 3] = rng.uniform(-np.pi, np.pi, N)
    Pr[:, 4] = np.where(rng.uniform(size=N) < 0.5, -1.0,
                        rng.uniform(0.0, np.pi, N))
    btype = rng.choice([BSDF_TYPES[t] for t in ELEMENTS], N).astype(np.int32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    for mode in (pbsdf.RADIANCE, pbsdf.IMPORTANCE):
        with ieee_reference():
            ref = ieee_jit(lambda a, b, c: jpol._element_mueller(
                a, b, c, mode))(Pr, btype, wi)
        _close_mueller(ppol._element_mueller(T(Pr), T(btype), T(wi), mode),
                       ref, 'element')
    Pp = np.zeros((N, 20), np.float32)
    Pp[:, 0:3] = rng.uniform(0.1, 0.9, (N, 3))
    Pp[:, 3] = 1.49
    Pp[:, 4] = 1.000277
    Pp[:, 6:9] = 1.0
    Pp[:, 9] = rng.uniform(0.02, 0.5, N)
    wi[:, 2] = np.maximum(np.abs(wi[:, 2]), 0.02)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 1e-3
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    with ieee_reference():
        ref = ieee_jit(lambda a, b, c: jpol._pplastic_mueller_eval(
            a, b, c, jbsdf.RADIANCE))(Pp, wi, wo)
    _close_mueller(ppol._pplastic_mueller_eval(T(Pp), T(wi), T(wo),
                                               pbsdf.RADIANCE),
                   ref, 'pplastic', tol=3e-4)

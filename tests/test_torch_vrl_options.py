"""The thesis's VRL options in the port against the reference, on the
two-pass boxes of ``torch_parity.two_pass_desc`` (16x8, 2 spp):

  * ``long_vrl`` and ``dice_vrl`` (``_lengthen_vrls``, ``_dice_vrls``) on
    the reference's maps carried over: lengths, fluxes, media, counts and
    order within 1e-5 relative, the valid masks equal;
  * ``vrl_aniso_cdf`` (``_aniso_cam_cdf``) on random segments with the
    reference compiled with IEEE rounding: t and 1/pdf within 1e-4
    relative on every lane;
  * ``vrl_ris`` (``_vrl_ris_weights`` within 1e-6 relative; the selected
    VRL of ``query_vrls``' RIS branch equal on at least 99% of lanes, the
    query within 1e-4 relative on those lanes: the running sums are
    compared with u * w_total, and a one-ulp difference of a cumulative
    sum may pick the neighbouring VRL);
  * ``use_bre`` (``estimate_beam``) in the homogeneous HG box and in a
    grid medium, within 1e-4 relative;
  * whole ``vrl`` renders with aniso, dice and long (the homogeneous HG
    box) and with RIS and BRE (the nonlinear box): the port's camera
    passes on the reference's maps, every pixel within 1e-3 relative, and
    the port's own light pass and camera passes against the reference's
    render, the golden suite's z-test and the means within 1e-3.

The reference's ``_lengthen_vrls`` and ``_dice_vrls`` leave its packed
VRL rows (``vrl_packed``) as the light pass wrote them, so its camera pass
reads the old lengths and, after dicing, undiced rows at clamped indices
(``test_reference_packed_rows_stay_stale``; ROADMAP queue C). The port
rebuilds the rows; the renders here hold it against the reference's
camera pass on maps whose rows the test rebuilds from their fields."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
from mitsuba_nlvrl_tpu.integrators import photon_est as jest
from mitsuba_nlvrl_tpu.integrators import vrl as jvrl
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch.core.rng import Sampler as PSampler
from mitsuba_nlvrl_tpu_torch.integrators import photon_est as pest
from mitsuba_nlvrl_tpu_torch.integrators import vrl as pvrl
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (build_both, ieee_jit, ieee_reference,
                          jax_meta_dict, scene_arrays, two_pass_case,
                          two_pass_desc, z_test_pass_fraction)

STAGE_RTOL = 1e-5
LANE_RTOL = 1e-4
RIS_SAME_SHARE = 0.99
SPP = 2
DICE = 3
# the two option sets the renders turn on, and the box each renders in
OPTIONS = {
    'aniso_dice_long': ('homogeneous', {'vrl_aniso_cdf': True,
                                        'dice_vrl': DICE, 'long_vrl': True}),
    'ris_bre': ('nonlinear', {'vrl_ris': True, 'use_bre': True}),
}
KEY = jax.random.fold_in(jax.random.PRNGKey(0), 0x9e37)   # preprocess key


def _close(a, b, name, rtol=STAGE_RTOL):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.shape == b.shape, name
    if a.dtype.kind in 'biu':
        assert (a == b).all(), name
        return
    scale = max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _with_options(meta, options):
    props = dict(meta.integrator_props)
    props.update(options)
    return dataclasses.replace(meta, integrator_props=tuple(
        sorted(props.items())))


def _repack(maps):
    """The reference's maps with ``vrl_packed`` rebuilt from its fields."""
    return maps._replace(vrl_packed=jnp.concatenate(
        [maps.vrl_o, maps.vrl_d, maps.vrl_len[:, None], maps.vrl_flux,
         maps.vrl_medium.astype(jnp.float32)[:, None],
         maps.vrl_valid.astype(jnp.float32)[:, None]], axis=1))


@functools.lru_cache(maxsize=None)
def _lengthened_diced():
    """The homogeneous HG box's reference maps, lengthened and diced by
    the reference (its preprocess's steps, in its order), and the port's
    scene and meta with the aniso, dice and long options."""
    sj, mj, maps_j, sp, mp, maps_p = two_pass_case('vrl', 'homogeneous')
    opts = OPTIONS['aniso_dice_long'][1]
    mj_o, mp_o = _with_options(mj, opts), _with_options(mp, opts)
    long_j = jvrl._lengthen_vrls(sj, maps_j)
    diced_j = jvrl._dice_vrls(sj, mj_o, jax.random.fold_in(KEY, 0xd1ce),
                              long_j, dice=DICE)
    diced_j = diced_j._replace(clusters=jvrl.build_vrl_clusters(
        sj, diced_j, 1024))
    return sj, mj_o, maps_j, long_j, diced_j, sp, mp_o, maps_p


def test_reference_packed_rows_stay_stale():
    """The reference fault the port repairs: after dicing, the reference's
    packed rows still hold the undiced map."""
    _, _, maps_j, _, diced_j, _, _, _ = _lengthened_diced()
    assert diced_j.vrl_o.shape[0] == 2 * DICE * maps_j.vrl_o.shape[0]
    assert diced_j.vrl_packed.shape == maps_j.vrl_packed.shape


def test_lengthen_vrls_matches_reference():
    sj, _, maps_j, long_j, _, sp, _, maps_p = _lengthened_diced()
    got = pvrl._lengthen_vrls(sp, maps_p)
    _close(long_j.vrl_len, got.vrl_len, 'lengths')
    assert float((got.vrl_len - maps_p.vrl_len).max()) > 0.1
    # the port's packed rows follow the fields
    _close(_repack(long_j).vrl_packed, got.vrl_packed, 'packed rows')


def test_dice_vrls_matches_reference():
    _, _, _, long_j, diced_j, sp, mp_o, _ = _lengthened_diced()
    carried = P.maps_from_numpy(scene_arrays(long_j), device='cpu')
    got = pvrl._dice_vrls(sp, mp_o, rng.fold_in(rng.fold_in(
        rng.PRNGKey(0), 0x9e37), 0xd1ce), carried, DICE)
    assert int(got.vrl_count) == int(diced_j.vrl_count) > 0
    for f in ('vrl_valid', 'vrl_medium', 'vrl_depth', 'vrl_direct'):
        _close(getattr(diced_j, f), getattr(got, f), f)
    for f in ('vrl_o', 'vrl_d', 'vrl_len', 'vrl_flux'):
        _close(getattr(diced_j, f), getattr(got, f), f)
    _close(_repack(diced_j).vrl_packed, got.vrl_packed, 'packed rows')


def _segments(seed, N=256):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = r.uniform(0.05, 1.0, N).astype(np.float32)
    return o, d, length, r


def test_aniso_cam_cdf_matches_reference():
    sj, mj_o, _, _, _, sp, mp_o, _ = _lengthened_diced()
    o, d, length, r = _segments(4)
    N = o.shape[0]
    p_vrl = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d_v = r.normal(size=(N, 3)).astype(np.float32)
    d_v /= np.linalg.norm(d_v, axis=1, keepdims=True)
    u2 = r.random(N).astype(np.float32)
    act = r.random(N) > 0.1
    med = np.zeros(N, np.int32)
    args = (med, med, o, d, length, p_vrl, d_v, u2, act)
    with ieee_reference():
        ref = ieee_jit(lambda *a: jvrl._aniso_cam_cdf(sj, mj_o, *a))(
            *(jnp.asarray(x) for x in args))
    got = pvrl._aniso_cam_cdf(sp, mp_o, *(torch.as_tensor(x) for x in args))
    for a, b, name in zip(ref, got, ('t_cam', 'inv_pdf_c', 'ok')):
        _close(a, b, name, LANE_RTOL)
    assert int(got[2].sum()) > N // 2


def test_ris_weights_match_reference():
    _, _, _, _, diced_j, _, _, _ = _lengthened_diced()
    maps_p = P.maps_from_numpy(scene_arrays(diced_j), device='cpu')
    o, d, length, _ = _segments(5)
    V = diced_j.vrl_o.shape[0]
    assert int(diced_j.vrl_count) > 300
    sl = np.concatenate([np.arange(300), np.full(212, -1)]).astype(np.int32)
    a = jvrl._vrl_ris_weights(diced_j, *(jnp.asarray(x)
                                         for x in (o, d, length, sl)))
    b = pvrl._vrl_ris_weights(maps_p, *(torch.as_tensor(x)
                                        for x in (o, d, length, sl)))
    _close(a, b, 'weights', 1e-6)
    assert float(b[:, 300:].abs().max()) == 0.0 and float(b.max()) > 0


def _record_vi(module, monkeypatch):
    seen = []
    real = module.vrl_contrib

    def record(scene, meta, maps, seg_o, seg_d, seg_len, cam_medium, vi,
               *rest):
        seen.append(np.array(vi))
        return real(scene, meta, maps, seg_o, seg_d, seg_len, cam_medium,
                    vi, *rest)
    monkeypatch.setattr(module, 'vrl_contrib', record)
    return seen


def test_ris_selection_matches_reference(monkeypatch):
    """The RIS branch of ``query_vrls`` over four 400-VRL chunks, the
    last padded, on the diced map."""
    sj, mj_o, _, _, diced_j, sp, mp_o, _ = _lengthened_diced()
    maps_j = _repack(diced_j)
    maps_p = P.maps_from_numpy(scene_arrays(maps_j), device='cpu')
    for mod in (jvrl, pvrl):
        monkeypatch.setattr(mod, 'VRL_RIS_CHUNK', 400)
    vi_j, vi_p = _record_vi(jvrl, monkeypatch), _record_vi(pvrl, monkeypatch)
    o, d, length, r = _segments(6)
    N = o.shape[0]
    cam = np.zeros(N, np.int32)
    channel = r.integers(0, 3, N).astype(np.int32)
    act = r.random(N) > 0.1
    q_j, s_j = jvrl.query_vrls(
        sj, mj_o, maps_j, *(jnp.asarray(x) for x in (o, d, length, cam,
                                                     channel)),
        JSampler.make(jax.random.PRNGKey(9), N), jnp.asarray(act), 2,
        strategy='ris')
    q_p, s_p = pvrl.query_vrls(
        sp, mp_o, maps_p, *(torch.as_tensor(x) for x in (o, d, length, cam,
                                                         channel)),
        PSampler.make(rng.PRNGKey(9), N), torch.as_tensor(act), 2,
        strategy='ris')
    assert len(vi_j) == len(vi_p) == 2 and int(s_j.dim) == s_p.dim
    same = (vi_j[0] == vi_p[0]) & (vi_j[1] == vi_p[1])
    assert same.mean() >= RIS_SAME_SHARE, same.mean()
    assert len(np.unique(vi_p[0])) > 50       # the draws spread
    _close(np.asarray(q_j)[same], q_p[torch.from_numpy(same)], 'query',
           LANE_RTOL)
    assert float(q_p.abs().max()) > 0


@pytest.mark.parametrize('medium', ['homogeneous', 'grid'])
def test_estimate_beam_matches_reference(medium):
    _, _, maps_j, _, _, _, _, maps_p = _lengthened_diced()
    if medium == 'homogeneous':
        sj, mj, _, sp, mp, _ = two_pass_case('vrl', 'homogeneous')
    else:
        # the photons of the homogeneous box, in a grid medium's box
        med = pscenes.hetvol_medium(grid_res=8, seed=0, scale=5.0)
        sj, mj, sp, mp = build_both(scenes.cornell_box(medium=med))
    o, d, length, r = _segments(7)
    N = o.shape[0]
    # each segment passes a volume photon within its first steps
    n_vp = int(maps_p.vp_valid.sum())
    assert n_vp > 0
    ph = maps_p.vp_pos[:n_vp].numpy()[r.integers(0, n_vp, N)]
    o = (ph - d * r.uniform(0.005, 0.05, (N, 1))).astype(np.float32)
    sr = float(pvrl.scene_radius_of(sp))
    # the camera pass's jittered volume radius: a step (2 r) spans about
    # the photon grid's cell
    radius = (np.float32(0.005 * sr)
              * (0.75 + 0.5 * r.random(N))).astype(np.float32)
    act = r.random(N) > 0.1
    midx = np.zeros(N, np.int32)
    args = (o, d, length, -d, midx, act, radius)
    a = jest.estimate_beam(sj, mj, maps_j, *(jnp.asarray(x) for x in args),
                           n_steps=8)
    b = pest.estimate_beam(sp, mp, maps_p, *(torch.as_tensor(x)
                                             for x in args), 8)
    _close(a, b, 'beam', LANE_RTOL)
    assert float(b.max()) > 0


@functools.lru_cache(maxsize=None)
def _render_case(name):
    """(reference image on its maps with rebuilt rows, the reference's
    maps carried to the port, the port's scene and meta) of an option
    set."""
    medium, opts = OPTIONS[name]
    if name == 'aniso_dice_long':
        sj, mj, _, _, maps_j, sp, mp, _ = _lengthened_diced()
    else:
        sj, mj, maps_j, sp, mp, _ = two_pass_case('vrl', medium)
        mj, mp = _with_options(mj, opts), _with_options(mp, opts)
    maps_j = _repack(maps_j)
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=SPP, aux=maps_j,
                                    spp_per_dispatch=1))
    maps_p = P.maps_from_numpy(scene_arrays(maps_j), device='cpu')
    return img_j, maps_p, sp, mp


@pytest.mark.parametrize('name', list(OPTIONS))
def test_render_on_reference_maps_matches_reference(name):
    img_j, maps_p, sp, mp = _render_case(name)
    img_p, _, _ = compare.render_with_passes(sp, mp, 0, SPP, maps_p)
    assert img_p.shape == img_j.shape
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert img_p.mean() > 0.005


@pytest.mark.parametrize('name', list(OPTIONS))
def test_render_own_light_pass_matches_reference(name):
    img_j, _, sp, mp = _render_case(name)
    img_p, passes, _ = compare.render_with_passes(sp, mp, 0, SPP)
    assert np.isfinite(img_p).all()
    z = z_test_pass_fraction(img_p, SPP, img_j, passes.var(axis=0, ddof=1),
                             SPP)
    assert z >= compare.Z_FRACTION, z
    assert abs(img_p.mean() - img_j.mean()) \
        <= compare.MEAN_RTOL * img_j.mean(), (img_p.mean(), img_j.mean())


@pytest.mark.parametrize('name', list(OPTIONS))
def test_options_build_from_both_routes(name):
    medium, opts = OPTIONS[name]

    def desc(pkg):
        d = two_pass_desc(pkg, 'vrl', medium)
        d['integrator'].update(opts)
        return d
    sp, mp = P.build_scene(desc(pscenes), device='cpu')
    assert all(mp.iprop(k) == v for k, v in opts.items())
    sj, mj = J.build_scene(desc(scenes))
    P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj), device='cpu')

"""The port's media modules against the reference's, stage by stage: the
builder's grid bounds and corner-packed rows, the .vol loader, the phase
functions, the medium lookups and walks, the occluder query, the medium
fields of a surface interaction and the null BSDF.

Both packages draw the same random numbers (the port's threefry equals
``jax.random`` bit for bit), so the walks take the same decisions except
where XLA's fused multiply-adds on the CPU move a float by an ulp and a
comparison flips. Tolerances, each found at these sizes: the walks' lanes
agree within 1e-4 relative (transmittance, collision points) and 1e-3
(delta-tracking weight) on at least 99% of lanes (found: every lane); the
phase functions within 1e-6 relative, the medium lookups and the null
BSDF's sample within 1e-5; the grid tables, the occluder query and the
medium fields of a hit exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu import medium as jmed
from mitsuba_nlvrl_tpu import phase as jphase
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
from mitsuba_nlvrl_tpu.ops import intersect as jisect
from mitsuba_nlvrl_tpu.scene import builder as jbuilder
from mitsuba_nlvrl_tpu.scene import vol_io as jvol

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch import medium as pmed
from mitsuba_nlvrl_tpu_torch import phase as pphase
from mitsuba_nlvrl_tpu_torch.core import rng as prng
from mitsuba_nlvrl_tpu_torch.core.records import SurfaceInteraction
from mitsuba_nlvrl_tpu_torch.core.ray import Ray as PRay
from mitsuba_nlvrl_tpu_torch.core.rng import Sampler as PSampler
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.scene import builder as pbuilder
from mitsuba_nlvrl_tpu_torch.scene import vol_io as pvol
from mitsuba_nlvrl_tpu_torch.scene.types import BSDF_TYPES
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both

HOMOGENEOUS = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8}


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the builder's grid tables --------------------------------------------

def _two_blobs(n=40):
    """Two small blobs in opposite corners of an n^3 grid: most of its
    5^3 blocks are vacuum, several blocks away from either blob."""
    x = (np.arange(n) + 0.5) / n
    g = np.zeros((n, n, n))
    for c in (0.1, 0.9):
        e = np.exp(-(x - c) ** 2 / (2 * 0.03 ** 2))
        g += e[:, None, None] * e[None, :, None] * e[None, None, :]
    g[g < 1e-3] = 0.0
    return g.astype(np.float32)


GRIDS = {
    'dense_13x11x10': lambda: np.random.default_rng(3).uniform(
        size=(13, 11, 10)).astype(np.float32),
    'sparse_two_blobs': _two_blobs,
}


@pytest.mark.parametrize('name', list(GRIDS))
def test_grid_tables_match_reference(name):
    g = GRIDS[name]()
    for kw in ({}, {'dilate_hi': 2}):
        for fn in ('_supervoxel_max', '_supervoxel_min'):
            a = getattr(pbuilder, fn)(g, **kw)
            b = getattr(jbuilder, fn)(g, **kw)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), fn
    packed = pbuilder._corner_pack(g)
    assert packed.tobytes() == jbuilder._corner_pack(g).tobytes()
    assert packed.shape == (g.size, 10)
    if name == 'sparse_two_blobs':
        # vacuum rows carry leap distances of 3 blocks and more
        assert -packed[:, 9].min() >= 3


def test_load_vol_reads_a_numpy_file(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.uniform(size=(3, 4, 5, 1)).astype('<f4')   # z, y, x, ch
    bbox = np.float32([-1, -2, -3, 1, 2, 3])
    path = tmp_path / 'g.vol'
    header = b'VOL' + bytes([3]) + np.int32([1, 5, 4, 3, 1]).tobytes()
    path.write_bytes(header + bbox.astype('<f4').tobytes() + data.tobytes())
    got = pvol.load_vol(str(path))
    ref = jvol.load_vol(str(path))
    assert got.data.tobytes() == ref.data.tobytes() == data.tobytes()
    assert (got.bbox_min == bbox[:3]).all() and (got.bbox_max
                                                 == bbox[3:]).all()
    assert got.max_value == ref.max_value
    path.write_bytes(b'VOX' + path.read_bytes()[3:])
    with pytest.raises(ValueError, match='not a Mitsuba'):
        pvol.load_vol(str(path))


# --- phase functions -------------------------------------------------------

PHASES = {'isotropic': {'type': 'isotropic'},
          'hg_0.8': {'type': 'hg', 'g': 0.8},
          'hg_-0.3': {'type': 'hg', 'g': -0.3},
          'hg_0': {'type': 'hg', 'g': 0.0}}


@pytest.mark.parametrize('name', list(PHASES))
def test_phase_matches_reference(name):
    med = dict(HOMOGENEOUS, phase=PHASES[name])
    sj, mj, sp, mp = build_both(scenes.cornell_box(medium=med))
    rng = np.random.default_rng(7)
    N = 512
    wi = rng.normal(size=(N, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = rng.normal(size=(N, 3))
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    midx = np.zeros(N, np.int32)
    act = rng.uniform(size=N) < 0.9
    ev_j = jphase.eval(sj, mj, jnp.asarray(midx), jnp.asarray(wi),
                       jnp.asarray(wo), jnp.asarray(act))
    ev_p = pphase.eval(sp, mp, _t(midx, torch.int32), _t(wi), _t(wo),
                       _t(act, torch.bool))
    np.testing.assert_allclose(_np(ev_p), _np(ev_j), rtol=1e-6, atol=1e-9)
    wo_j, pdf_j = jphase.sample(sj, mj, jnp.asarray(midx), jnp.asarray(wi),
                                jnp.asarray(u2), jnp.asarray(act))
    wo_p, pdf_p = pphase.sample(sp, mp, _t(midx, torch.int32), _t(wi),
                                _t(u2), _t(act, torch.bool))
    np.testing.assert_allclose(_np(wo_p), _np(wo_j), rtol=1e-6, atol=1e-6)
    # the sample's pdf is the phase value at the sampled direction; the
    # HG lobe's slope turns an ulp of wo into up to 1e-5 of pdf, so the
    # reference's pdf is held against the port's value at its own wo
    pdf_at_j = pphase.eval(sp, mp, _t(midx, torch.int32), _t(wi),
                           _t(_np(wo_j)), _t(act, torch.bool))
    np.testing.assert_allclose(_np(pdf_at_j), _np(pdf_j), rtol=1e-6,
                               atol=1e-9)
    assert torch.equal(pdf_p, pphase.eval(sp, mp, _t(midx, torch.int32),
                                          _t(wi), wo_p, _t(act, torch.bool)))
    assert (_np(pdf_p)[~act] == 0).all() and (_np(pdf_p)[act] > 0).all()


# --- medium lookups and walks ----------------------------------------------

@pytest.fixture(scope='module')
def hetvol():
    """The hetvol box at a 16^3 grid (sigma_t x20) in both packages, and
    rays from all around the medium cube (many cross it, some start in
    it, some miss it)."""
    med = pscenes.hetvol_medium(grid_res=16, seed=0, scale=20.0)
    sj, mj, sp, mp = build_both(scenes.cornell_box(medium=med))
    rng = np.random.default_rng(11)
    N = 2048
    o = rng.uniform(-1.4, 1.4, size=(N, 3)).astype(np.float32)
    tgt = rng.uniform(-0.6, 0.6, size=(N, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    # a few axis-parallel directions: zero components in the slab test
    d[:64] = np.eye(3, dtype=np.float32)[np.arange(64) % 3] \
        * np.where(np.arange(64) % 2, 1, -1)[:, None]
    return sj, mj, sp, mp, o, d


def _rays(o, d, mint, maxt):
    return (JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
                 jnp.asarray(maxt)),
            PRay(_t(o), _t(d), _t(mint), _t(maxt)))


def test_scattering_coefficients_and_aabb_match_reference(hetvol):
    sj, mj, sp, mp, o, d = hetvol
    N = o.shape[0]
    rng = np.random.default_rng(2)
    p = rng.uniform(-1.0, 1.0, size=(N, 3)).astype(np.float32)
    act = rng.uniform(size=N) < 0.9
    m0 = np.zeros(N, np.int32)
    got = pmed.get_scattering_coefficients(sp, mp, _t(m0, torch.int32),
                                           _t(p), _t(act, torch.bool))
    ref = jmed.get_scattering_coefficients(sj, mj, jnp.asarray(m0),
                                           jnp.asarray(p), jnp.asarray(act))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    assert (_np(got[2]) > 0).any() and (_np(got[2]) == 0).any()
    # the packed lookup and the plain trilinear one agree
    lo, hi = pmed.medium_bbox(sp, _t(m0, torch.int32))
    np.testing.assert_allclose(
        _np(pmed._grid_lookup(sp.media.grid_sigma_t, lo, hi, _t(p))),
        _np(pmed._sigma_grid_eval(sp, lo, hi, _t(p))), rtol=1e-5,
        atol=1e-6)

    jr, pr = _rays(o, d, np.zeros(N, np.float32),
                   np.full(N, np.inf, np.float32))
    hit_p, mint_p, maxt_p = pmed.intersect_aabb(sp, mp, _t(m0, torch.int32),
                                                pr)
    hit_j, mint_j, maxt_j = jmed.intersect_aabb(sj, mj, jnp.asarray(m0), jr)
    assert (_np(hit_p) == _np(hit_j)).all()
    assert 0 < _np(hit_p).sum() < N
    for a, b in ((mint_p, mint_j), (maxt_p, maxt_j)):
        a, b = _np(a), _np(b)
        assert (np.isnan(a) == np.isnan(b)).all()
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=1e-6, atol=1e-6)


def _samplers(N, seed=3, dim=5):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    kp = prng.fold_in(prng.PRNGKey(seed), 1)
    return (JSampler(kj, jnp.int32(dim), N),
            PSampler(kp, dim, N, torch.zeros(()), torch.device('cpu')))


def _share_close(a, b, rtol, atol=1e-6):
    close = np.abs(a - b) <= atol + rtol * np.abs(b)
    return float(close.reshape(close.shape[0], -1).all(axis=1).mean())


@pytest.mark.parametrize('packed', [True, False])
def test_segment_tr_matches_reference(hetvol, packed):
    """Ratio tracking through the corner-packed rows, and through the
    plain trilinear lookup and supervoxel gather that grids too large to
    pack take."""
    sj, mj, sp, mp, o, d = hetvol
    if not packed:
        sj = sj._replace(media=sj.media._replace(grid_sigma_p8=None))
        sp = sp._replace(media=sp.media._replace(grid_sigma_p8=None))
    N = o.shape[0]
    rng = np.random.default_rng(4)
    seg = rng.uniform(0.5, 4.0, size=N).astype(np.float32)
    act = rng.uniform(size=N) < 0.95
    ch = rng.integers(0, 3, size=N).astype(np.int32)
    m0 = np.zeros(N, np.int32)
    smp_j, smp_p = _samplers(N)
    tr_j, sj2 = jmed.segment_tr(sj, mj, smp_j, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(seg),
                                jnp.asarray(m0), jnp.asarray(ch),
                                jnp.asarray(act))
    tr_p, sp2 = pmed.segment_tr(sp, mp, smp_p, _t(o), _t(d), _t(seg),
                                _t(m0, torch.int32), _t(ch, torch.int32),
                                _t(act, torch.bool))
    assert sp2.dim == int(sj2.dim) == 6
    tr_p, tr_j = _np(tr_p), _np(tr_j)
    assert np.isfinite(tr_p).all()
    # the grid attenuates many lanes and blocks none fully by chance alone
    assert ((tr_p < 0.99) & (tr_p > 0)).any() and (tr_p[~act] == 1).all()
    assert _share_close(tr_p, tr_j, 1e-4) >= 0.99


def test_sample_real_interaction_matches_reference(hetvol):
    sj, mj, sp, mp, o, d = hetvol
    N = o.shape[0]
    rng = np.random.default_rng(5)
    ch = rng.integers(0, 3, size=N).astype(np.int32)
    act = rng.uniform(size=N) < 0.95
    m0 = np.zeros(N, np.int32)
    maxt = rng.uniform(1.0, 5.0, size=N).astype(np.float32)
    jr, pr = _rays(o, d, np.zeros(N, np.float32), maxt)
    smp_j, smp_p = _samplers(N, seed=8)
    mi_j, w_j, sj2 = jmed.sample_real_interaction(
        sj, mj, jr, smp_j, jnp.asarray(ch), jnp.asarray(m0),
        jnp.asarray(act))
    mi_p, w_p, sp2 = pmed.sample_real_interaction(
        sp, mp, pr, smp_p, _t(ch, torch.int32), _t(m0, torch.int32),
        _t(act, torch.bool))
    assert sp2.dim == int(sj2.dim)
    valid_p, valid_j = _np(mi_p.valid), _np(mi_j.valid)
    assert 0.05 < valid_p.mean() < 0.95      # both real collisions and
    agree = valid_p == valid_j               # escapes
    assert agree.mean() >= 0.99
    for f in ('t', 'p', 'sigma_s', 'sigma_t', 'combined_extinction'):
        a, b = _np(getattr(mi_p, f))[agree & valid_p], \
            _np(getattr(mi_j, f))[agree & valid_p]
        assert _share_close(a, b, 1e-4) >= 0.99, f
    assert _share_close(_np(w_p)[agree], _np(w_j)[agree], 1e-3) >= 0.99
    assert np.isfinite(_np(w_p)).all()


def test_walk_caps_and_lockstep(hetvol):
    """A walk stops at max_steps events (the reference's cap) and leaves
    the capped lanes marked; lanes do not change each other's draws."""
    sj, mj, sp, mp, o, d = hetvol
    N = o.shape[0]
    m0 = _t(np.zeros(N, np.int32), torch.int32)
    ch = _t(np.zeros(N, np.int32), torch.int32)
    pr = PRay(_t(o), _t(d), torch.zeros(N), torch.full((N,), 5.0))
    hit, mint, maxt = pmed.intersect_aabb(sp, mp, m0, pr)
    mint, maxt = torch.clamp(mint, min=0.0), torch.clamp(maxt, max=5.0)
    walking = hit & (maxt > mint)
    key = prng.PRNGKey(9)
    full = pmed._majorant_walk(sp, mp, pr, key, ch, m0, mint, maxt, walking,
                               track=True, max_steps=4096)
    capped = pmed._majorant_walk(sp, mp, pr, key, ch, m0, mint, maxt,
                                 walking, track=True, max_steps=8)
    assert capped[-1] == 8 and full[-1] > 8
    assert bool(capped[5].any()) and not bool(full[5].any())
    half = torch.arange(N) < N // 2
    part = pmed._majorant_walk(sp, mp, pr, key, ch, m0, mint, maxt,
                               walking & half, track=True, max_steps=4096)
    for a, b in zip(part[:5], full[:5]):
        assert torch.equal(a[half], b[half])


# --- occluders, medium fields of a hit, the null BSDF ----------------------

@pytest.fixture(scope='module')
def cube_in_box():
    sj, mj, sp, mp = build_both(scenes.cornell_box(medium=HOMOGENEOUS))
    rng = np.random.default_rng(13)
    N = 4096
    o = rng.uniform(-0.99, 0.99, size=(N, 3)).astype(np.float32)
    o[: N // 2, 2] = -3.2                    # half from the camera
    d = rng.normal(size=(N, 3))
    d[: N // 2] = rng.uniform(-0.3, 0.3, size=(N // 2, 3)) + [0, 0, 1]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = rng.uniform(0.2, 6.0, size=N).astype(np.float32)
    return sj, mj, sp, mp, _rays(o, d, np.full(N, 1e-4, np.float32), maxt)


def test_occluder_subset_and_query_match_reference(cube_in_box):
    sj, mj, sp, mp, (jr, pr) = cube_in_box
    tri_b = sp.shapes.bsdf_idx[sp.geo.shape_idx.long()]
    occ = sp.bsdfs.type[tri_b.long()] != BSDF_TYPES['null']
    assert (sp.geo.v0.shape[0], sp.occluders.v0.shape[0]) == (24, 12)
    for f in ('v0', 'e1', 'e2'):
        assert torch.equal(getattr(sp.occluders, f),
                           getattr(sp.geo, f)[occ])
    got = _np(pisect.ray_test_occluders(sp, pr))
    ref = _np(jisect.ray_test_occluders(sj, jr))
    assert (got == ref).all()
    # the null cube blocks ray_test but not the occluder query
    blocked = _np(pisect.ray_test(sp, pr))
    assert (blocked & ~got).any() and not (got & ~blocked).any()


def test_compute_si_medium_fields_match_reference(cube_in_box):
    sj, mj, sp, mp, (jr, pr) = cube_in_box
    si_p = pisect.ray_intersect(sp, pr)
    si_j = jisect.ray_intersect(sj, jr)
    for f in ('valid', 'shape_idx', 'bsdf_idx', 'int_medium',
              'ext_medium'):
        assert (_np(getattr(si_p, f)) == _np(getattr(si_j, f))).all(), f
    trans = _np(si_p.is_medium_transition())
    assert trans.any() and (_np(si_p.int_medium)[trans] == 0).all()
    assert (_np(si_p.ext_medium) == -1).all()
    d = pr.d
    np.testing.assert_array_equal(_np(si_p.target_medium(d)),
                                  _np(si_j.target_medium(jr.d)))
    np.testing.assert_array_equal(_np(si_p.target_medium(-d)),
                                  _np(si_j.target_medium(-jr.d)))
    inv = SurfaceInteraction.invalid((3,))
    assert not inv.valid.any() and (inv.int_medium == -1).all()


def test_null_bsdf_matches_reference(cube_in_box):
    sj, mj, sp, mp, (jr, pr) = cube_in_box
    si_p = pisect.ray_intersect(sp, pr)
    si_j = jisect.ray_intersect(sj, jr)
    N = pr.o.shape[0]
    rng = np.random.default_rng(17)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    bs_p, w_p = pbsdf.sample(sp, mp, si_p, _t(u1), _t(u2))
    bs_j, w_j = jbsdf.sample(sj, mj, si_j, jnp.asarray(u1), jnp.asarray(u2))
    null = _np(bs_p.null)
    assert null.any() and (~null).any()
    assert (null == _np(bs_j.null)).all()
    for f in ('delta', 'pdf', 'eta'):
        np.testing.assert_allclose(_np(getattr(bs_p, f)),
                                   _np(getattr(bs_j, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(_np(bs_p.wo)[null], -_np(si_p.wi)[null])
    np.testing.assert_allclose(_np(w_p), _np(w_j), rtol=1e-5, atol=1e-6)
    assert (_np(w_p)[null] == 1).all()
    assert (_np(pbsdf.flags_of(sp, si_p))
            == _np(jbsdf.flags_of(sj, si_j))).all()
    tr_p = _np(pbsdf.eval_null_transmission(sp, mp, si_p))
    assert (tr_p == _np(jbsdf.eval_null_transmission(sj, mj, si_j))).all()
    assert (tr_p[null] == 1).all() and (tr_p[~null] == 0).all()


def test_nonlinear_media_are_not_in_the_slice():
    """Nonlinear media build (tests/test_torch_nonlinear.py), with the
    beam radiance estimate (tests/test_torch_vrl_options.py) and, since
    slice 12, the map all-reduce across ranks (``map_psum_axis``,
    tests/test_torch_sharded_maps.py): from the port's builder and from
    a reference scene carried over, nothing of a nonlinear box raises."""
    integ = {'type': 'vrl', 'map_psum_axis': 'mp'}
    desc = pscenes.cornell_box(medium={'type': 'nonlinear'},
                               integrator=integ)
    _, mp = P.build_scene(desc, device='cpu')
    assert mp.iprop('map_psum_axis') == 'mp'
    sj, mj = J.build_scene(scenes.cornell_box(medium={'type': 'nonlinear'},
                                              integrator=integ))
    from torch_parity import jax_meta_dict, scene_arrays
    _, mc = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                               device='cpu')
    assert mc.iprop('map_psum_axis') == mj.iprop('map_psum_axis') == 'mp'
    P.build_scene(pscenes.cornell_box(medium={'type': 'nonlinear'},
                                      integrator={'type': 'vrl',
                                                  'use_bre': True}),
                  device='cpu')


def test_record_walks_counts_the_walks_and_restores():
    """The measurement scripts' walk recorder: every walk of a render is
    logged with its mode and trips, its operations are a share of the
    render's, and the walk is restored on exit."""
    from mitsuba_nlvrl_tpu_torch.testing.walk_probe import record_walks
    real = pmed._majorant_walk
    sp, mp = P.build_scene(pscenes.hetvol_box(8, 6, spp=1, grid_res=16,
                                              seed=0, scale=20.0),
                           device='cpu')
    with record_walks(count_ops=True) as log:
        P.render(sp, mp, seed=0, spp=1)
    assert pmed._majorant_walk is real
    assert {w['track'] for w in log.walks} == {True, False}
    assert log.trips() == log.trips(True) + log.trips(False) > 0
    assert 0 < sum(w['ops'] for w in log.walks) < log.ops


# --- slice 8: albedo grids, the medium helpers, refused textures ------------

def test_medium_helpers_match_reference(hetvol):
    """The helpers no integrator calls: free-flight sampling against the
    hero channel's majorant, the segment's transmittance and pdf, the
    closed-form homogeneous transmittance and the constant-extinction
    mask (the interaction within 1e-6 relative; the transmittances and
    pdfs, exponentials of the sampled distances' log1p, within 1e-5:
    1.3e-6 at most measured)."""
    sj, mj, sp, mp, o, d = hetvol
    N = o.shape[0]
    rng = np.random.default_rng(21)
    u = rng.uniform(size=N).astype(np.float32)
    ch = rng.integers(0, 3, N).astype(np.int32)
    m0 = np.where(rng.uniform(size=N) < 0.9, 0, -1).astype(np.int32)
    act = rng.uniform(size=N) < 0.95
    maxt = np.where(rng.uniform(size=N) < 0.5, np.inf,
                    rng.uniform(0.5, 4.0, N)).astype(np.float32)
    jr, pr = _rays(o, d, np.zeros(N, np.float32), maxt)
    mi_j, mint_j = jax.jit(lambda s, r, a, b, c, e: jmed.sample_interaction(
        s, mj, r, a, b, c, e))(sj, jr, jnp.asarray(u), jnp.asarray(ch),
                               jnp.asarray(m0), jnp.asarray(act))
    mi_p, mint_p = pmed.sample_interaction(
        sp, mp, pr, _t(u), _t(ch, torch.int32), _t(m0, torch.int32),
        _t(act, torch.bool))
    assert (_np(mi_p.valid) == _np(mi_j.valid)).all()
    assert 0 < _np(mi_p.valid).sum() < N
    for f in ('t', 'p', 'sigma_s', 'sigma_n', 'sigma_t',
              'combined_extinction', 'wi'):
        np.testing.assert_allclose(_np(getattr(mi_p, f)),
                                   _np(getattr(mi_j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(_np(mint_p), _np(mint_j), rtol=1e-6,
                               atol=1e-6)
    si_t = rng.uniform(0.1, 5.0, N).astype(np.float32)
    tr_j, pdf_j = jmed.eval_tr_and_pdf(mi_j, mint_j, jnp.asarray(si_t),
                                       jnp.asarray(act))
    tr_p, pdf_p = pmed.eval_tr_and_pdf(mi_p, mint_p, _t(si_t),
                                       _t(act, torch.bool))
    np.testing.assert_allclose(_np(tr_p), _np(tr_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(pdf_p), _np(pdf_j), rtol=1e-5, atol=1e-7)
    length = rng.uniform(-0.5, 3.0, N).astype(np.float32)
    np.testing.assert_allclose(
        _np(pmed.homogeneous_transmittance(sp, _t(m0, torch.int32),
                                           _t(length), _t(act, torch.bool))),
        _np(jmed.homogeneous_transmittance(sj, jnp.asarray(m0),
                                           jnp.asarray(length),
                                           jnp.asarray(act))),
        rtol=1e-5, atol=1e-7)
    for sj_, mj_, sp_, mp_ in ((sj, mj, sp, mp), build_both(
            scenes.cornell_box(medium=HOMOGENEOUS))):
        assert (_np(pmed.is_homogeneous_like(sp_, mp_, _t(m0, torch.int32)))
                == _np(jmed.is_homogeneous_like(sj_, mj_,
                                                jnp.asarray(m0)))).all()


def test_albedo_grid_box_matches_reference():
    """A heterogeneous medium whose albedo is a gridvolume: both builders
    carry the grid and set the row's albedo to one (no integrator of the
    reference reads the grid), and the volpath renders agree (every pixel
    within 1e-3 relative, the rays equal)."""
    from mitsuba_nlvrl_tpu_torch.testing import compare
    from torch_parity import ieee_reference
    med = pscenes.albedo_grid_medium(grid_res=8, scale=10.0)
    desc_p = pscenes.cornell_box(spp=2, res=8, medium=med,
                                 integrator={'type': 'volpath',
                                             'max_depth': 6})
    sp_own, _ = P.build_scene(desc_p, device='cpu')
    sj, mj, sp, mp = build_both(scenes.cornell_box(
        spp=2, res=8, medium=med,
        integrator={'type': 'volpath', 'max_depth': 6}))
    grid = np.asarray(med['albedo']['_grid'].data)
    for s_ in (sj, sp_own):
        np.testing.assert_array_equal(_np(s_.media.grid_albedo), grid)
        np.testing.assert_array_equal(_np(s_.media.params)[0, 3:6], 1.0)
    stats = []
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=2, ray_stats=stats,
                                    spp_per_dispatch=1))
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert rays_p == sum(float(r) for r in stats)


@pytest.mark.parametrize('medium', [
    {'type': 'homogeneous', 'sigma_t': {'type': 'checkerboard'},
     'albedo': 0.8},
    {'type': 'heterogeneous', 'sigma_t': {'type': 'checkerboard'}},
])
def test_textured_media_are_refused_as_the_reference_refuses_them(medium):
    """A textured homogeneous medium, or a heterogeneous one whose textured
    sigma_t is not a gridvolume: the reference's builder fails on the
    texture (its RGB reader returns None), and the port's raises a
    ValueError that says so."""
    with pytest.raises((TypeError, ValueError)):
        J.build_scene(scenes.cornell_box(spp=1, res=4, medium=medium))
    with pytest.raises(ValueError, match='refuse'):
        P.build_scene(pscenes.cornell_box(spp=1, res=4, medium=medium),
                      device='cpu')

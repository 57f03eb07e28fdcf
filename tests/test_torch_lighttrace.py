"""The port's light pass against the reference's: the key split, the
emitters' emission rays, the wavefront photon and VRL shooting (a
homogeneous box, and the nonlinear box of ``cbox_nlvrl`` lit by its
laser), the thinning to the map budgets and the map build.

Both packages draw the same random numbers, so they shoot the same light
paths. The nonlinear box runs the reference with IEEE rounding
(``torch_parity.ieee_reference``): its bends turn on the last bit at
every total internal reflection. Its transcendental functions still round
otherwise than torch's in some values (sin, cos, log1p and exp of 5-17%
of uniform inputs, XLA against torch on the CPU), so a path that scatters
and later reflects totally may bend once more or once less in one
package, and the rows after it shift in the reservoir. Found at these
sizes (256 paths, 6 bounces, 8 bends a bounce): the homogeneous box equal
in every count and every row within 1e-4, in order; the nonlinear box
equal in its photon counts and rows, lost deposits and truncated paths,
with 4,887 and 4,899 VRL deposits (0.25%), of which 42 and 54 (1.1%) have
no copy (rounded to 1e-3) among the other package's. The gates allow 0.5%
of the VRL deposits and 2% of the rows of each family.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.integrators import lighttrace as jlt
from mitsuba_nlvrl_tpu import emitter as jem
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch import emitter as pem
from mitsuba_nlvrl_tpu_torch.integrators import lighttrace as plt
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference

ROW_TOL = 1e-4
SHOOT = dict(n_paths=256, max_depth=6, rr_depth=5, min_vrl_len=0.0,
             sp_cap=4096, vp_cap=4096, vrl_cap=8192)
HOMOGENEOUS = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8}


@pytest.mark.parametrize('n', [2, 3, 5])
def test_split_matches_jax(n):
    for seed in (0, 7, 2**31 + 5):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x7411)
        ref = np.asarray(jax.random.key_data(jax.random.split(key, n))
                         if jax.dtypes.issubdtype(key.dtype,
                                                  jax.dtypes.prng_key)
                         else jax.random.split(key, n)).astype(np.int64)
        got = rng.split(rng.fold_in(rng.PRNGKey(seed), 0x7411), n)
        assert len(got) == n
        for i in range(n):
            assert got[i].tolist() == ref[i].tolist()


@functools.lru_cache(maxsize=None)
def _scenes(name):
    if name == 'nl_laser':
        desc = scenes.cornell_box(
            spp=1, res=8, medium=dict(pscenes.NLVRL_MEDIUM, res_y=64),
            integrator={'type': 'vrl', 'use_laser': True,
                        'laser_origin': pscenes.LASER_ORIGIN,
                        'laser_direction': pscenes.LASER_DIRECTION})
    else:
        desc = scenes.cornell_box(spp=1, res=8, integrator={'type': 'vrl'},
                                  medium=HOMOGENEOUS, light=name)
    return build_both(desc)


@pytest.mark.parametrize('light', ['area', 'point', 'constant'])
def test_sample_ray_matches_reference(light):
    sj, mj, sp, mp = _scenes(light)
    r = np.random.default_rng(3)
    N = 2048
    u_sel = r.random(N).astype(np.float32)
    u_pos = r.random((N, 2)).astype(np.float32)
    u_dir = r.random((N, 2)).astype(np.float32)
    act = r.random(N) > 0.1
    a = jem.sample_ray(sj, mj, *(jnp.asarray(x)
                                 for x in (u_sel, u_pos, u_dir, act)))
    b = pem.sample_ray(sp, mp, *(torch.as_tensor(x)
                                 for x in (u_sel, u_pos, u_dir, act)))
    for x, y, name in ((a[0].o, b[0].o, 'o'), (a[0].d, b[0].d, 'd'),
                       (a[0].mint, b[0].mint, 'mint'), (a[1], b[1], 'w'),
                       (a[3], b[3], 'n')):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert (np.asarray(a[2]) == b[2].numpy()).all()
    assert b[0].d.is_contiguous() and b[0].o.is_contiguous()


@functools.lru_cache(maxsize=None)
def _shoot(name):
    """(reference raw deposits, the port's) of 256 paths."""
    sj, mj, sp, mp = _scenes(name)
    bends = 8 if name == 'nl_laser' else 0
    with ieee_reference():
        ref = ieee_jit(functools.partial(jlt.shoot, max_bends=bends,
                                         **SHOOT),
                       static_argnames=('meta',))(
            sj, mj, jax.random.PRNGKey(3))
    got = plt.shoot(sp, mp, rng.PRNGKey(3), max_bends=bends, **SHOOT)
    return ref, got


COUNTS = ('sp_count', 'vp_count', 'vrl_count', 'sp_lost', 'vp_lost',
          'vrl_lost', 'trunc_paths')
FAMILIES = {'sp': ('sp_pos', 'sp_power', 'sp_dir', 'sp_normal', 'sp_depth',
                   'sp_caustic'),
            'vp': ('vp_pos', 'vp_power', 'vp_dir', 'vp_depth'),
            'vrl': ('vrl_o', 'vrl_e', 'vrl_flux', 'vrl_medium', 'vrl_depth',
                    'vrl_direct')}
VRL_DEPOSIT_RTOL = 5e-3     # the nonlinear box's VRL deposits
ROW_SET_RTOL = 2e-2         # its rows missing from the other package


def _rows(raw, family):
    """The family's valid rows as one (n, k) float64 array."""
    n = int(getattr(raw, f'{family}_count'))
    cols = [np.asarray(getattr(raw, f))[:n].astype(np.float64)
            .reshape(n, -1) for f in FAMILIES[family]]
    return np.concatenate(cols, axis=1)


def _unmatched(a, b):
    """Rows of a whose 1e-3-rounded copy b lacks."""
    def key(x):
        return collections.Counter(map(tuple, np.round(x * 1e3).astype(
            np.int64)))
    return sum((key(a) - key(b)).values())


@pytest.mark.parametrize('name', ['area', 'nl_laser'])
def test_shoot_matches_reference(name):
    ref, got = _shoot(name)
    vrl_total = [int(r.vrl_count) + int(r.vrl_lost) for r in (ref, got)]
    exact = COUNTS if name == 'area' else \
        ('sp_count', 'vp_count', 'sp_lost', 'vp_lost', 'vrl_lost',
         'trunc_paths')
    for f in exact:
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    assert abs(vrl_total[1] - vrl_total[0]) \
        <= VRL_DEPOSIT_RTOL * vrl_total[0], vrl_total
    assert int(got.vrl_count) > 100 and int(got.sp_count) > 100
    assert int(got.vp_count) > 50
    for family in FAMILIES:
        a, b = _rows(ref, family), _rows(got, family)
        if name == 'area':
            np.testing.assert_allclose(b, a, rtol=ROW_TOL, atol=ROW_TOL,
                                       err_msg=family)
        else:
            for x, y in ((a, b), (b, a)):
                assert _unmatched(x, y) <= ROW_SET_RTOL * len(x), family


def _to_port_raw(raw):
    return plt.RawDeposits(**{f: torch.as_tensor(np.array(getattr(raw, f)))
                              for f in plt.RawDeposits._fields})


def test_thin_and_build_maps_match_reference():
    """The reference's deposits of the homogeneous box, carried over,
    thinned to budgets below their counts and built into maps by both
    packages: the kept rows equal, the hash grids equal, the per-photon
    radii within 4e-7 relative (the port's cube root is pow(x, 1/3), the
    reference's cbrt)."""
    sj, mj, sp, mp = _scenes('area')
    ref_raw, _ = _shoot('area')
    caps = dict(sp_cap=200, vp_cap=100, vrl_cap=300)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x7411)
    thin_j = jax.jit(functools.partial(jlt.thin_raw, **caps))(key, ref_raw)
    thin_p = plt.thin_raw(rng.fold_in(rng.PRNGKey(0), 0x7411),
                          _to_port_raw(ref_raw), **caps)
    for f in plt.RawDeposits._fields:
        a, b = np.asarray(getattr(thin_j, f)), getattr(thin_p, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind in 'biu':
            assert (a == b).all(), f
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                       err_msg=f)
    assert int(thin_p.sp_count) == 200 and int(thin_p.vrl_count) == 300

    radii = (0.1, 0.05, 0.04)
    maps_j = jlt.build_maps(sj, mj, thin_j, *radii)
    maps_p = plt.build_maps(sp, mp, thin_p,
                            *(torch.tensor(r) for r in radii))
    for f in plt.PhotonMaps._fields:
        a, b = getattr(maps_j, f), getattr(maps_p, f)
        if f == 'clusters':
            assert a is None and b is None
            continue
        for g in (a._fields if hasattr(a, '_fields') else (None,)):
            x = np.asarray(getattr(a, g) if g else a)
            y = (getattr(b, g) if g else b).numpy()
            assert x.shape == y.shape, (f, g)
            if x.dtype.kind in 'biu':
                assert (x == y).all(), (f, g)
            else:
                tol = 4e-7 if f in ('vp_radius', 'vp_packed') else 1e-7
                np.testing.assert_allclose(y, x, rtol=tol, atol=1e-9,
                                           err_msg=f'{f}.{g}')
    assert plt.map_stats(maps_p) == jlt.map_stats(maps_j)



def test_compact_dev_matches_reference():
    """The fixed-capacity compaction (valid rows first, stable), below
    and above the valid count."""
    r = np.random.default_rng(4)
    valid = r.random(500) > 0.6
    rows = r.normal(size=(500, 3)).astype(np.float32)
    ids = np.arange(500, dtype=np.int32)
    for cap in (100, 500):
        n_j, m_j, (a_j, b_j) = jlt._compact_dev(
            jnp.asarray(valid), [jnp.asarray(rows), jnp.asarray(ids)], cap)
        n_p, m_p, (a_p, b_p) = plt._compact_dev(
            torch.as_tensor(valid), [torch.as_tensor(rows),
                                     torch.as_tensor(ids)], cap)
        assert int(n_p) == int(n_j) == min(int(valid.sum()), cap)
        assert (m_p.numpy() == np.asarray(m_j)).all()
        assert (a_p.numpy() == np.asarray(a_j)).all()
        assert (b_p.numpy() == np.asarray(b_j)).all()

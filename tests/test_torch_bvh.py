"""The port's BVH against the reference's: the same native build, the same
traversal (nearest and any hit, an overflowing stack, the iteration cap)
run with IEEE rounding on the reference's side, the same scene tables
from 1,024 triangles, and the same render of a mesh scene.

The reference's leaf test runs inside its ``lax.while_loop``, where XLA's
CPU backend contracts the t of a hit into fused multiply-adds even at
optimisation level 0, so t differs in the last bit; the hit triangles do
not."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import native as jnative
from mitsuba_nlvrl_tpu.ops import bvh as jbvh
from mitsuba_nlvrl_tpu.scene import xml as jxml
from mitsuba_nlvrl_tpu_torch.ops import bvh as pbvh
from mitsuba_nlvrl_tpu_torch.ops.cuda.intersect_cuda import \
    intersect_tris_plain
from mitsuba_nlvrl_tpu_torch.scene import xml as pxml
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

from torch_parity import ieee_jit, ieee_reference, scene_arrays

T_RTOL = 1e-5      # t of a hit, relative (see the module docstring)
PIXEL_RTOL = 1e-3  # the whole render, every pixel



@pytest.fixture(scope='module')
def jax_native():
    """The reference's native BVH builder, loaded. The reference compiles
    it at first use into one temporary file that every test process
    shares, so test workers that start together can race and leave it
    unloaded in some; here the library is compiled again under a
    process's own temporary name and the reference's cached failure is
    dropped. Decided when a test asks, not when the module is imported."""
    if jnative.bvh_builder() is None:
        if shutil.which('g++') is None:
            pytest.skip("no g++: the reference's native BVH builder is "
                        "unavailable")
        here = os.path.dirname(jnative.__file__)
        so = os.path.join(here, 'libbvh_native.so')
        tmp = f'{so}.{os.getpid()}.tmp'
        subprocess.run(['g++', '-O3', '-std=c++17', '-shared', '-fPIC',
                        '-march=native', os.path.join(here, 'bvh_native.cpp'),
                        '-o', tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, so)
        jnative._LIBS.pop('bvh_native', None)
    assert jnative.bvh_builder() is not None


def _soup(seed=0, T=2000):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(seed=1, N=4096):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16, 1:] = 0.0              # axis-parallel rays: |d| clamps
    d[:16, 0] = 1.0
    mint = np.full(N, 1e-4, np.float32)
    maxt = np.full(N, np.inf, np.float32)
    maxt[::7] = 0.8               # bounded rays
    return o, d, mint, maxt


@pytest.fixture(scope='module')
def soup_case():
    """The 2,000-triangle soup, its BVH (port build) and the reordered
    triangles."""
    v0, e1, e2 = _soup()
    bvh = pbvh.build(v0, e1, e2)
    order = np.asarray(bvh.order)
    return bvh, (v0[order], e1[order], e2[order])


_JTRAVERSE = ieee_jit(jbvh.traverse, static_argnames=('any_hit',))


def _torch(bvh):
    return pbvh.BVHArrays(*(torch.as_tensor(np.asarray(x)) for x in bvh))


def _both(bvh, tris, rays, any_hit):
    """(reference, port) traverse results as numpy."""
    jb = jbvh.BVHArrays(*(jnp.asarray(np.asarray(x)) for x in bvh))
    rj = _JTRAVERSE(jb, *(jnp.asarray(x) for x in tris),
                    *(jnp.asarray(x) for x in rays), any_hit=any_hit)
    rp = pbvh.traverse(_torch(bvh),
                       *(torch.as_tensor(x) for x in tris),
                       *(torch.as_tensor(x) for x in rays), any_hit=any_hit)
    return [np.asarray(x) for x in rj], [x.numpy() for x in rp]


def _assert_same(rj, rp, any_hit):
    tj, ij, uj, vj = rj
    tp, ip, up, vp = rp
    assert np.array_equal(np.isfinite(tj), np.isfinite(tp))
    hit = np.isfinite(tj)
    np.testing.assert_allclose(tp[hit], tj[hit], rtol=T_RTOL, atol=0)
    if any_hit:
        return
    assert np.array_equal(ip, ij)
    assert (ip[~hit] == -1).all() and np.isinf(tp[~hit]).all()
    np.testing.assert_allclose(up, uj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-6)


def test_build_matches_reference(jax_native):
    v0, e1, e2 = _soup()
    bj = jbvh.build(v0, e1, e2)
    bp = pbvh.build(v0, e1, e2)
    for f in jbvh.BVHArrays._fields:
        a, b = np.asarray(getattr(bp, f)), np.asarray(getattr(bj, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert sorted(np.asarray(bp.order)) == list(range(len(v0)))


@pytest.mark.parametrize('any_hit', [False, True])
def test_traverse_matches_reference(soup_case, any_hit):
    bvh, tris = soup_case
    pbvh.reset_stats()
    rj, rp = _both(bvh, tris, _rays(), any_hit)
    _assert_same(rj, rp, any_hit)
    assert np.isfinite(rp[0]).sum() > 500
    assert pbvh.stats['calls'] == 1 and pbvh.stats['lanes_cut'] == 0


def test_traverse_matches_dense_plain_version(soup_case):
    bvh, tris = soup_case
    rays = [torch.as_tensor(x) for x in _rays(seed=2)]
    tt = [torch.as_tensor(x) for x in tris]
    for any_hit in (False, True):
        tb = pbvh.traverse(_torch(bvh), *tt, *rays,
                           any_hit=any_hit)
        td = intersect_tris_plain(*tt, *rays, any_hit=any_hit)
        assert torch.equal(tb[0].isfinite(), td[0].isfinite())
        if not any_hit:
            assert torch.equal(tb[1], td[1])


def _chain(levels: int, deep_first: bool, T: int):
    """A hand-made tree: a chain of ``levels`` inner nodes, each with a
    leaf child. ``deep_first``: the chain continues in child a (pushed
    last, popped first), so every level leaves its leaf on the stack and
    the stack overflows past STACK_DEPTH; otherwise it continues in b and
    the walk takes two steps a level. Every box holds the whole scene."""
    M = 2 * levels + 1
    lo = np.full((M, 3), -10.0, np.float32)
    hi = np.full((M, 3), 10.0, np.float32)
    a = np.zeros(M, np.int32)
    b = np.zeros(M, np.int32)
    leaf = np.zeros(M, bool)
    for k in range(levels):
        inner, lf, nxt = 2 * k, 2 * k + 1, 2 * k + 2
        a[inner], b[inner] = (nxt, lf) if deep_first else (lf, nxt)
        leaf[lf] = True
        a[lf], b[lf] = (7 * k) % (T - 8), 1 + k % 8
    leaf[M - 1] = True
    a[M - 1], b[M - 1] = 0, 8
    return pbvh.BVHArrays(lo, hi, a, b, leaf, np.arange(T, dtype=np.int32))


@pytest.mark.parametrize('any_hit', [False, True])
def test_stack_overflow_matches_reference(soup_case, any_hit):
    _, tris = soup_case
    tree = _chain(pbvh.STACK_DEPTH + 30, True, len(tris[0]))
    rj, rp = _both(tree, tris, _rays(seed=3, N=512), any_hit)
    _assert_same(rj, rp, any_hit)


def test_iteration_cap_matches_reference(soup_case, monkeypatch):
    """Lanes still walking at the step cap keep their best hit. Both
    packages read the cap from their module, so the test lowers it (to a
    value that is not a multiple of the port's 8-step block, whose last
    block is then cut short) and walks a chain longer than the cap."""
    assert pbvh.MAX_TRAV_ITERS == jbvh.MAX_TRAV_ITERS == 4096
    cap = 100
    monkeypatch.setattr(pbvh, 'MAX_TRAV_ITERS', cap)
    monkeypatch.setattr(jbvh, 'MAX_TRAV_ITERS', cap)
    _, tris = soup_case
    tree = _chain(cap // 2 + 20, False, len(tris[0]))
    rays = _rays(seed=4, N=64)
    pbvh.reset_stats()
    jtrav = ieee_jit(jbvh.traverse, static_argnames=('any_hit',))
    rj = jtrav(jbvh.BVHArrays(*(jnp.asarray(np.asarray(x)) for x in tree)),
               *(jnp.asarray(x) for x in tris),
               *(jnp.asarray(x) for x in rays), any_hit=False)
    rp = pbvh.traverse(_torch(tree), *(torch.as_tensor(x) for x in tris),
                       *(torch.as_tensor(x) for x in rays), any_hit=False)
    _assert_same([np.asarray(x) for x in rj], [x.numpy() for x in rp],
                 False)
    # every lane enters every box, so each is still walking at the cap
    assert pbvh.stats['max_steps'] == cap
    assert pbvh.stats['lanes_cut'] == 64
    # and the cap cut the walk short: the full walk finds other hits
    monkeypatch.setattr(pbvh, 'MAX_TRAV_ITERS', 4 * cap)
    full = pbvh.traverse(_torch(tree), *(torch.as_tensor(x) for x in tris),
                         *(torch.as_tensor(x) for x in rays))
    assert not torch.equal(full[1], rp[1])


@pytest.fixture(scope='module')
def mesh_scene(tmp_path_factory, jax_native):
    """cbox_mesh at subdivision 3 (1,292 triangles) and 16x16, 2 spp,
    loaded and built by both packages."""
    path = pscenes.cbox_mesh(str(tmp_path_factory.mktemp('cbox_mesh')),
                             subdiv=3, spp=2, res=16)
    sj, mj = J.build_scene(jxml.load_file(path))
    sp, mp = P.build_scene(pxml.load_file(path), device='cpu')
    return sj, mj, sp, mp


def test_mesh_scene_tables_match_reference(mesh_scene):
    """From 1,024 triangles: the reordered triangle tables, the BVH and
    the remapped emitter triangle ids equal the reference's."""
    sj, mj, sp, mp = mesh_scene
    ref, port = scene_arrays(sj), scene_arrays(sp)
    assert mp.n_tris == mj.n_tris == 1292 and mp.has_bvh and mj.has_bvh
    assert {k for k in port if k.startswith('bvh.')} == \
        {f'bvh.{f}' for f in pbvh.BVHArrays._fields}
    for k, a in port.items():
        assert a.dtype == ref[k].dtype and np.array_equal(a, ref[k]), k
    # the light's triangles, found through the remapped ids, are its own
    light = port['emitters.shape_idx'][0]
    idx = port['emitters.em_tri_idx']
    assert (port['geo.shape_idx'][idx] == light).all() and len(idx) == 2


def test_mesh_render_matches_reference(mesh_scene):
    """The 16x16, 2 spp render of cbox_mesh through the BVH: every pixel
    within 1e-3 of the reference's. The ray counts may differ by a few
    lanes in a thousand: a diffuse bounce off the smooth-shaded sphere
    draws its direction through sin and cos, whose last bit XLA and torch
    round apart, and a path that later samples the light from a point in
    the light's own plane turns on that bit (1,816 rays against the
    reference's 1,817 here)."""
    sj, mj, sp, mp = mesh_scene
    stats_j, stats_p = [], []
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=2,
                                    ray_stats=stats_j))
    pbvh.reset_stats()
    img_p = P.render(sp, mp, seed=0, spp=2, ray_stats=stats_p).numpy()
    assert img_p.shape == img_j.shape == (16, 16, 3)
    close = np.abs(img_p - img_j) <= PIXEL_RTOL * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    rays_j = sum(float(r) for r in stats_j)
    rays_p = sum(float(r) for r in stats_p)
    assert abs(rays_p - rays_j) <= compare.RAYS_RTOL * rays_j, \
        (rays_p, rays_j)
    assert img_p.mean() > 0.05
    # 2 passes x 8 bounces x (nearest hit + shadow rays), all through
    # the BVH
    assert pbvh.stats['calls'] == 32 and pbvh.stats['lanes_cut'] == 0

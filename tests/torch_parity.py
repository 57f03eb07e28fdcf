"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

They carry a reference (JAX) scene into the port as numpy arrays, so both
packages render the very same arrays, and hold images against each other
with the golden suite's per-pixel z-test.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_golden_suite import _z_test

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P

# one intra-op thread a process: the Tier-1 command runs six pytest
# workers on the machine's cores, and each worker collects every file
torch.set_num_threads(1)


def scene_arrays(scene) -> dict:
    """Flatten a SceneData of either package into {dotted field path:
    ndarray}, the form ``scene_from_numpy`` takes; a tuple's items take
    their index ("emitters.env_warp.levels.0"). The port's occluder
    subset is left out: ``scene_from_numpy`` derives it from the other
    arrays (tests/test_torch_medium.py checks it)."""
    out = {}

    def walk(prefix, node):
        if node is None or prefix == 'occluders':
            return
        if hasattr(node, '_fields'):
            for f in node._fields:
                walk(f'{prefix}.{f}' if prefix else f, getattr(node, f))
        elif isinstance(node, tuple):    # the warp's levels; () absent
            for i, x in enumerate(node):
                walk(f'{prefix}.{i}', x)
        elif hasattr(node, 'shape'):
            out[prefix] = np.asarray(node)
    walk('', scene)
    return out


def port_si(si):
    """A reference SurfaceInteraction as the port's record (CPU
    tensors)."""
    from mitsuba_nlvrl_tpu_torch.core.frame import Frame
    from mitsuba_nlvrl_tpu_torch.core.records import SurfaceInteraction

    def t(x):
        return torch.as_tensor(np.array(x))
    return SurfaceInteraction(**{
        f: (Frame(*(t(v) for v in si.sh_frame)) if f == 'sh_frame'
            else t(getattr(si, f)))
        for f in SurfaceInteraction._fields})


def jax_meta_dict(meta) -> dict:
    return dataclasses.asdict(meta)


def build_both(desc):
    """(reference scene, reference meta, port scene, port meta), the port's
    built from the reference's own arrays on the CPU."""
    sj, mj = J.build_scene(desc)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    return sj, mj, sp, mp


def z_test_pass_fraction(mean, spp, ref, ref_var, ref_spp, alpha=0.01):
    """Fraction of pixels whose two-sided p-value clears the Sidak
    threshold of the golden suite (tests/test_golden_suite.py::_gate)."""
    p = _z_test(mean, spp, ref, ref_var, ref_spp)
    alpha_c = 1.0 - (1.0 - alpha) ** (1.0 / p.size)
    return float((p >= alpha_c).mean())


# XLA's CPU backend at its default optimisation fuses a multiply and an
# add into one rounding, and rewrites 1/sqrt into an approximate rsqrt;
# torch rounds every operation and the port's normalisation divides by a
# correctly rounded sqrt. A ray bent by the nonlinear medium turns on the
# last bit at every total internal reflection (the reflected ray starts
# RayEpsilon past the cell face and its next exit lies RayEpsilon away),
# so the nonlinear tests evaluate the reference with IEEE rounding:
# compiled at optimisation level 0 (no contraction) with 1/sqrt kept
# apart by an optimisation barrier.
_IEEE_OPTIONS = {'xla_backend_optimization_level': 0}
_JIT = jax.jit


def ieee_jit(fn, **kw):
    """``jax.jit(fn)`` compiled with IEEE rounding (loops outside a jit
    compile with XLA's default rounding)."""
    return _JIT(fn, compiler_options=_IEEE_OPTIONS, **kw)


@contextlib.contextmanager
def ieee_reference(nested: bool = False):
    """Inside the block the reference's jitted functions, those it makes
    at call time and its render pass, compile with IEEE rounding. With
    ``nested`` the jits the reference makes at call time stay plain: the
    caller wraps them in one top-level ``ieee_jit`` (JAX refuses compiler
    options on a jit inside another jit or a grad)."""
    import mitsuba_nlvrl_tpu.core.math as jm
    jrender = sys.modules['mitsuba_nlvrl_tpu.render']
    real = (jm.safe_rsqrt, jrender.render_pass)
    tiny = jnp.finfo(jnp.float32).tiny

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        return ieee_jit(fn, **kw)

    jm.safe_rsqrt = lambda x: 1.0 / jax.lax.optimization_barrier(
        jnp.sqrt(jnp.maximum(x, tiny)))
    if not nested:
        jax.jit = jit
    jrender.render_pass = jit(jrender._pass_body,
                              static_argnames=('meta', 'integrator'))
    try:
        yield
    finally:
        jm.safe_rsqrt, jrender.render_pass = real
        jax.jit = _JIT


# the two-pass integrators' test boxes: the reference's static knobs cut
# to test size (target_vrls <= 256, light_depth_cap <= 8, max_nl_bends <=
# 8, gather_points_cap <= 8, max_cam_iters <= 4, global_photons <= 4096),
# every light segment a VRL
TWO_PASS_KNOBS = dict(target_vrls=256, light_depth_cap=8, max_nl_bends=8,
                      gather_points_cap=8, max_cam_iters=4,
                      global_photons=4096, min_vrl_length=0.0,
                      samples_per_query=2)
TWO_PASS_RES = (16, 8)
# a homogeneous box with an anisotropic phase (the estimates' per-photon
# phase path)
HOMOGENEOUS_HG = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8,
                  'phase': {'type': 'hg', 'g': 0.5}}


def two_pass_desc(pkg, integrator: str, medium: str):
    """The 16x8 box of a two-pass test, from either package's scene
    module: ``medium`` 'homogeneous' (area light) or 'nonlinear' (the
    medium and laser of ``cbox_nlvrl``)."""
    from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes
    integ = {'type': integrator, 'use_light_cut': True, **TWO_PASS_KNOBS}
    if medium == 'nonlinear':
        med = dict(pscenes.NLVRL_MEDIUM)
        integ.update(use_laser=True, laser_origin=pscenes.LASER_ORIGIN,
                     laser_direction=pscenes.LASER_DIRECTION)
    else:
        med = dict(HOMOGENEOUS_HG)
    desc = pkg.cornell_box(spp=2, res=TWO_PASS_RES[0], integrator=integ,
                           medium=med)
    desc['sensor']['film']['height'] = TWO_PASS_RES[1]
    return desc


@functools.lru_cache(maxsize=None)
def two_pass_case(integrator: str, medium: str):
    """(reference scene, meta, maps; port scene, meta, the reference's
    maps carried over) of ``two_pass_desc``, the maps from the
    reference's preprocess with IEEE rounding."""
    import scenes
    from mitsuba_nlvrl_tpu.render import preprocess
    sj, mj, sp, mp = build_both(two_pass_desc(scenes, integrator, medium))
    with ieee_reference():
        maps_j = preprocess(sj, mj, 0)
    maps_p = P.maps_from_numpy(scene_arrays(maps_j), device='cpu')
    return sj, mj, maps_j, sp, mp, maps_p


@functools.lru_cache(maxsize=None)
def two_pass_reference_image(integrator: str, medium: str, spp: int):
    """(image, rays) of the reference's camera passes on its own maps,
    with IEEE rounding."""
    sj, mj, maps_j, _, _, _ = two_pass_case(integrator, medium)
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=spp, aux=maps_j,
                                  ray_stats=stats, spp_per_dispatch=1))
    return img, sum(float(r) for r in stats)


def check_render_on_reference_maps(integrator: str, medium: str, spp: int):
    """The port's camera passes on the reference's maps: every pixel
    within 1e-3 relative of the reference's, the ray counts equal."""
    from mitsuba_nlvrl_tpu_torch.testing import compare
    _, _, _, sp, mp, maps_p = two_pass_case(integrator, medium)
    img_j, rays_j = two_pass_reference_image(integrator, medium, spp)
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, spp, maps_p)
    assert img_p.shape == img_j.shape == TWO_PASS_RES[::-1] + (3,)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert rays_p == rays_j
    assert img_p.mean() > 0.005
    return img_p


def check_render_own_light_pass(integrator: str, medium: str, spp: int):
    """The port's whole render (its own preprocess and camera passes)
    against the reference's camera passes on the reference's maps: the
    golden suite's z-test on 99% of pixels, the means within 1e-3
    relative."""
    from mitsuba_nlvrl_tpu_torch.testing import compare
    _, _, _, sp, mp, _ = two_pass_case(integrator, medium)
    img_j, _ = two_pass_reference_image(integrator, medium, spp)
    img_p, passes, _ = compare.render_with_passes(sp, mp, 0, spp)
    assert np.isfinite(img_p).all()
    z = z_test_pass_fraction(img_p, spp, img_j, passes.var(axis=0, ddof=1),
                             spp)
    assert z >= compare.Z_FRACTION, z
    assert abs(img_p.mean() - img_j.mean()) \
        <= compare.MEAN_RTOL * img_j.mean(), (img_p.mean(), img_j.mean())


def reference_stokes_images(sj, mj, spp: int):
    """The reference's four Stokes component images of a ``stokes`` scene
    (``path`` nested, spectral or not) and its ray count, from one
    compiled pass that keeps every component: each pass is the
    reference's ``_pass_body`` (its keys, sensor rays, film splat), under
    ``ieee_reference``. Returns ((4, H, W, 3) developed images, rays)."""
    from mitsuba_nlvrl_tpu import film as jfilm, sensor as jsensor
    from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
    from mitsuba_nlvrl_tpu.integrators import path_polarized as jpol
    from mitsuba_nlvrl_tpu.integrators import path_spectral_polarized as jsp
    from mitsuba_nlvrl_tpu.integrators.aov import _nested
    from mitsuba_nlvrl_tpu.integrators.common import film_sample_positions
    mod = jsp if mj.spectral else jpol
    _, inner = _nested(mj)
    N = mj.film.width * mj.film.height

    def one_pass(scene, key, p):
        pos_key, samp_key = jax.random.split(key)
        pos, pos01 = film_sample_positions(mj, pos_key, p)
        ray, sw = jsensor.sample_ray(
            scene, mj, pos01,
            jax.random.uniform(jax.random.fold_in(pos_key, 1), (N, 2)))
        stokes, _, smp = mod.sample_full(scene, inner,
                                         JSampler.make(samp_key, N), ray)
        jit = pos - jnp.floor(pos)
        imgs = []
        for c in range(4):
            L = jnp.where(jnp.isfinite(stokes[:, :, c]), stokes[:, :, c],
                          0.0) * sw
            imgs.append(jfilm.splat_pixel_ordered(mj.film, jit, L,
                                                  jfilm.new_image(mj.film)))
        return jnp.stack(imgs), smp.rays

    acc, rays = 0.0, 0.0
    with ieee_reference():
        f = ieee_jit(one_pass)
        for p in range(spp):
            img, r = f(sj, jax.random.fold_in(jax.random.PRNGKey(0), p),
                       jnp.uint32(p))
            acc = acc + np.asarray(img)
            rays += float(r)
    return np.stack([np.asarray(jfilm.develop(a)) for a in acc]), rays


def check_stokes_render(sp, mp, images_j, rays_j, component: int, spp: int):
    """The port's ``stokes`` render of ``component`` against the
    reference's image: every pixel within 1e-3 of the pixel's largest
    S0 channel (S1-S3 are signed and cross zero), the rays equal."""
    from mitsuba_nlvrl_tpu_torch.testing import compare
    from mitsuba_nlvrl_tpu_torch.testing.scenes import with_component
    img_p, _, rays_p = compare.render_with_passes(
        sp, with_component(mp, component), 0, spp)
    ref = images_j[component]
    scale = np.abs(images_j[0]).max(axis=-1, keepdims=True)
    bad = np.abs(img_p - ref) > 1e-3 * scale + 1e-6
    assert not bad.any(), (component, float(np.abs(img_p - ref).max()))
    assert rays_p == rays_j
    return img_p

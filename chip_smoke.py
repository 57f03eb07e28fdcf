"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # PERF.md gives its time on an H100

Builds the port's CUDA kernel from the sources in this checkout, checks
the launch geometry the kernel works out for itself, holds the kernel
against its plain PyTorch version on the card (camera rays, and cases at
the kernel's edges: the shared-memory triangle cap and the ring above it,
ragged and misaligned ray arrays, grids one tile short of or over the
resident blocks), times it at the main path's shape (262,144 rays x 12
triangles) and at 1,023 random triangles, checks and times it on the rays
of every intersection call of one pass of the render, drives the port's
main path (``build_scene`` -> ``render`` of the 512x512 Cornell box, 16
spp, ``path`` with max_depth 8, its light the reference cbox.xml's SPD)
through it, and checks the render against the same scene rendered on the
CPU. The scene-file path follows: the CLI (``python -m
mitsuba_nlvrl_tpu_torch``, in a subprocess) renders ``cbox_xml``, the
same box written as Mitsuba XML over OBJ meshes, whose arrays must equal
the dict's and whose EXR must agree with the in-process render (equal
rays, ``testing/compare.py``'s gates); ``cbox_mesh`` (the box with a
20,480-triangle displaced icosphere in a binary PLY) is loaded and its
BVH built and described, rendered at 512x512, 4 spp through
``ops/bvh.traverse`` (wall time, rays, host syncs, the traversal's share
of the time, steps a call, lanes cut at the step cap), rendered at 64x64
on the card against the CPU, and one pass's camera rays go through the
BVH and through the kernel's dense nearest hit on the same triangles.
The volumetric slice follows: every intersection call of one pass of
the heterogeneous-medium box
(``hetvol_box``: 768x576, a 128^3 density grid, sigma_t x100, HG phase,
``volpath`` with max_depth 8) checked against the plain version and
timed, the 2 spp render itself (wall time, rays, kernel launches, host
syncs, the share of the time spent in the medium's collision walk), and a
64x64 heterogeneous ``volpath`` and homogeneous ``volpathmis`` render on
the card against the CPU. The NLVRL slice follows: ``cbox_nlvrl``
(512x256, the Cornell box around a nonlinear medium with a 640-cell IOR
grid, lit by a laser; ``vrl`` with 8,000 VRLs and cluster selection) is
built, its preprocess (the light pass, the photon maps and the VRL
clusters) is run and reported, every intersection call of one render
(preprocess and one camera pass) is checked against the plain version
and timed (every k-th call alone), the 2 spp render itself is timed by
parts (bend march, volume gather, VRL query, surface gathers), and a
64x32 ``vrl`` and ``photonmapper`` render of the box on the card is held
against the CPU on the CPU's own maps (strictly) and on each device's
own maps (map counts, image means within 5%). The microfacet and plastic
BSDFs follow: ``cbox_materials`` (the box with a rough gold block, a
rough plastic block, a plastic back wall, a two-sided floor, a rough
glass sphere, a polarized-plastic sphere and a thin glass pane; 512x512,
16 spp, ``path``) with every kernel call of one pass checked and timed,
and under the photon mapper in a homogeneous medium (512x256, 2 spp, the
per-photon BSDF gathers), each against the CPU at 64x64 or 64x32. Then
the thesis options on the NLVRL box: ``cbox_nlvrl_aniso`` (HG g = 0.8,
the tabulated anisotropic camera CDF, diced and lengthened VRLs; the
``long_vrl`` call checked and timed alone) and ``cbox_nlvrl_ris_bre``
(RIS VRL selection and the beam radiance estimate), each preprocessed,
rendered at 512x256, 2 spp and held against the CPU at 64x32. Then
textures, the wrapper BSDFs, the remaining lights, samplers and sensors:
``cbox_textured`` (a scene file written into a temporary directory: the
box with a checkerboard floor, a bitmap back wall, normal- and
bump-mapped blocks, a blended sphere, a masked pane, a shapegroup placed
twice, a spot light; multijitter sampler, thin lens; 512x512, 16 spp)
with every kernel call of one pass checked and timed, rendered in
process and through the CLI (its EXR equal to the in-process render),
``env_spheres`` (an environment map from an EXR, a directional sun, a
slide projector, grid3d and mesh-attribute textures; stratified; 512x512,
16 spp), and the card against the CPU on both at 64x64, on ``direct``,
``depth``, the radiance and irradiance meters, a photon-mapper box lit
by a spot and a directional light, and on the five samplers' jitter.
Then spectral and polarized transport, the wrapper integrators and the
regeneration scheduler: ``cbox_spectral`` (the box under the reference
cbox.xml's tabulated light with two blocks of a named conductor whose
eta/k curves the phase writes; 512x512, 16 spp, in process and through
the CLI's ``--spectral``, its EXR equal in bits), ``cbox_polarized``
(``stokes`` around ``path``: a polarizer, a quarter-wave retarder, a
circular element, a glass sphere, conductor blocks, a pplastic wall;
512x512, 16 spp, components 0 and 1, then spectral component 3), each
with every kernel call of one pass checked and timed, ``hetvol_volpath``
through the regeneration scheduler (``MNT_REGEN=1``) beside the pass
loop's render, and the card against the CPU at 64x64 on each of them, on
``aov``, ``moment``, an albedo-grid medium and a fog box under
regeneration, with regeneration held to the pass loop by the noise rule.
Then differentiable rendering (``autodiff.render``, checkpointed bounces
and walks, torch autograd): ``cbox_path_grad`` (the inverse-rendering
loop at 512x512: a target render, the BSDF parameters at 0.3 times
their values, 8 Adam steps of a 1 spp render and its backward pass) and
``hetvol_volpath_grad`` (the gradient of the 768x576 ``hetvol_box``'s
mean image with respect to its 128^3 density grid, then one SGD step
through ``with_sigma_grid``), every kernel call of one diff step of each
held to the plain version as it is made, the backward pass's recompute
included, and the card's gradients against the CPU's on a 64x64 box and
a 24x24 heterogeneous box (``autodiff_checks``).
Then the measured BSDFs, the double variant and the repaired spectral
fallback: ``cbox_measured`` (the box with an isotropic and an
anisotropic synthesized measured block, read from an XML file and its
``.bsdf`` files; 512x512, 16 spp, ``path`` max_depth 8; in process and
through the CLI, its EXR equal in bits), ``cbox_measured_polarized`` (a
``.pbsdf`` sphere under ``stokes`` around ``path``; 512x512, 16 spp),
each with every kernel call of one pass checked and timed; the float64
kernel against its float64 plain version (the double scene's camera
rays and edge cases) and timed at 262,144 x 12 against its bound;
``cbox_path`` in float64 (512x512, 16 spp: every float64 kernel call of
one pass bit for bit, the render beside the float32 render's wall, one
float64 gradient step); and the card against the CPU on each of them,
on a spectral ``volpath`` render of ``hetvol_box`` and a spectral
``vrl`` render of ``cbox_nlvrl`` (``item10_checks``).
The CPU halves of the two-pass checks against the CPU run in one
spawned worker process beside the card's phases, which the script ends
on every exit. Each phase prints one JSON line; the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero. Without a CUDA device it
exits non-zero at once and prints no result. It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


_T0 = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if 'phase' in obj:
        obj = {**obj, 'elapsed_s': time.time() - _T0}
    print(json.dumps(obj), flush=True)


# --- the card's published peaks (NVIDIA data sheets, dense) ----------------
# (memory bytes/s, fp32 FLOP/s outside the tensor cores, fp64 FLOP/s
# outside the tensor cores)
_PEAKS = (('H200', 4.8e12, 67e12, 34e12), ('H100 NVL', 3.9e12, 60e12, 30e12),
          ('H100 PCIe', 2.0e12, 51e12, 26e12),
          ('H100', 3.35e12, 67e12, 34e12))

# arithmetic of one ray-triangle test in csrc/intersect.cu (products,
# sums and the division; the seven comparisons are not counted)
FLOPS_PER_PAIR = 46


# the float64 render's own gate against the CPU, set from its readings
# (PERF.md §4): at least DOUBLE_PIXEL_FRACTION of the pixels within
# DOUBLE_RTOL relative (every pixel cannot be: the warps of the float32
# uniforms stay float32, as in the reference, and the card's float32 sin
# and cos part from the CPU's by an ulp) and the means within
# DOUBLE_MEAN_RTOL; a float32 render of the same scene misses both
DOUBLE_RTOL = 1e-6
DOUBLE_PIXEL_FRACTION = 0.995
DOUBLE_MEAN_RTOL = 1e-8


# triangles the kernel keeps whole in shared memory (kWholeMaxTris in
# csrc/intersect.cu); above it they stream through a ring
WHOLE_SET_CAP = 1024

# depth cuts that keep the script within its time limit (PERF.md §4):
# the mesh render's samples, the march caps (``gather_points_cap``, 64 by
# default) of the volume gather of cbox_materials_pm and cbox_nlvrl_aniso
# and of the beam estimate's steps a segment in cbox_nlvrl_ris_bre, and
# that scene's bends a camera ray (``max_nl_bends``, 32 by default)
MESH_SPP = 4
GATHER_CAP = 16
BRE_STEPS = 8
BRE_BENDS = 8
# and of two checks against the CPU, whose CPU side is slow: the
# heterogeneous box's samples (4 uncut), and the photons and camera
# iterations of cbox_materials_pm at 64x32 (100,000 and 24)
HETVOL_CHECK_SPP = 2
PM_CHECK_CUTS = {'global_photons': 20000, 'volume_photons': 20000,
                 'max_cam_iters': 4}
# and, to make room for slice 9's phases (PERF.md §4): the depth of
# the polarized renders, of the volumetric checks against the CPU (the
# heterogeneous and homogeneous boxes, the albedo grid, regeneration
# against the pass loop) and of the mesh check (8 uncut; the photon
# mapper check's camera iterations above, 8 before)
CUT_DEPTH = 4


def peaks(name: str):
    """(memory bytes/s, fp32 FLOP/s, fp64 FLOP/s) of the card."""
    for key, bw, fl, fl64 in _PEAKS:
        if key in name:
            return bw, fl, fl64
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(fn, reps: int, inner: int) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in
    a CUDA graph (so the wrapper's host work does not pace the device) and
    the graph is replayed ``reps`` times between CUDA events; the median
    over the replays, divided by ``inner``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def host_ms(fn, calls: int) -> float:
    """Host time of one call, device work included, as the render issues
    it (one call after another, synchronised at the end)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def bound(N: int, T: int, any_hit: bool, bw: float, fl: float,
          fbytes: int = 4):
    """(bytes, flops, bytes-bound ms, ops-bound ms) of one call: every
    input byte read once and every output byte written once (t, idx, u, v
    for nearest hit, t alone for any hit) over the memory rate,
    FLOPS_PER_PAIR a ray-triangle pair over the float rate ``fl`` (fp32,
    or fp64 with ``fbytes`` 8 for the float64 kernel)."""
    nbytes = (N * 8 * fbytes + 9 * T * fbytes
              + N * (fbytes if any_hit else 3 * fbytes + 4))
    nops = FLOPS_PER_PAIR * N * T
    return nbytes, nops, nbytes / bw * 1e3, nops / fl * 1e3


def kernel_time(torch, kern, tris, rays, bw, fl) -> dict:
    """Device times of the kernel (nearest and any hit) and of the plain
    version, the launch the kernel makes (nearest hit), the wrapper's host
    time a call, and the bounds."""
    N, T = rays[0].shape[0], tris[0].shape[0]
    ms = time_ms(lambda: kern.intersect_tris(*tris, *rays), 7, 50)
    ms_any = time_ms(lambda: kern.intersect_tris(*tris, *rays,
                                                 any_hit=True), 7, 50)
    plain_ms = time_ms(lambda: kern.intersect_tris_plain(*tris, *rays),
                       5, 3)
    call_ms = host_ms(lambda: kern.intersect_tris(*tris, *rays), 200)
    call_any_ms = host_ms(lambda: kern.intersect_tris(*tris, *rays,
                                                      any_hit=True), 200)
    nbytes, nops, bound_bytes_ms, bound_ops_ms = bound(N, T, False, bw, fl)
    nbytes_any, _, bound_bytes_any_ms, _ = bound(N, T, True, bw, fl)
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_any_ms = max(bound_bytes_any_ms, bound_ops_ms)
    geo = kern.geometry(N, T)
    return {'ms': ms, 'ms_any_hit': ms_any, 'plain_ms': plain_ms,
            'grid': geo.grid, 'smem_bytes': geo.smem_bytes,
            'ring': geo.ring, 'ray_tiles': -(-N // geo.ray_tile),
            'sms': torch.cuda.get_device_properties(
                rays[0].device).multi_processor_count,
            'host_ms_per_call': call_ms,
            'host_ms_per_call_any_hit': call_any_ms, 'bytes': nbytes,
            'bytes_any_hit': nbytes_any, 'flops': nops,
            'bound_ms': bound_ms, 'bound_bytes_ms': bound_bytes_ms,
            'bound_ops_ms': bound_ops_ms, 'bound_ms_any_hit': bound_any_ms,
            'bound_by': ('bytes' if bound_bytes_ms >= bound_ops_ms
                         else 'operations'),
            'roofline_share': bound_ms / ms,
            'roofline_share_any_hit': bound_any_ms / ms_any}


def geometry_check(torch, kern) -> dict:
    """The launch the library works out for itself, at the kernel's
    edges: at least one block and never more than ray tiles, the ring from
    just above the whole-set cap on, shared memory within a block's
    limit."""
    props = torch.cuda.get_device_properties(0)
    limit = getattr(props, 'shared_memory_per_block_optin', 232448)
    cap, seen = WHOLE_SET_CAP, {}
    for N in (1, 255, 257, 262144, 100003, 1 << 28):
        for T in (0, 12, 1023, cap, cap + 1, 5000):
            for any_hit in (False, True):
                g = kern.geometry(N, T, any_hit)
                rec = (N, T, any_hit, g)
                assert 1 <= g.grid <= max(1, -(-N // g.ray_tile)), rec
                assert g.ring == (T > cap), rec
                assert 0 < g.smem_bytes <= limit, rec
                if N == 262144:
                    seen[f"{T}{'_any' if any_hit else ''}"] = g._asdict()
    return {'smem_limit': limit, 'main_rays': seen}


def against_plain(torch, kern, tris, rays, any_hit) -> dict:
    """One call of the kernel against its plain version on the same
    inputs: occlusion equal; for nearest hit also idx and the bits of t, u
    and v. Fails on any mismatch."""
    got = kern.intersect_tris(*tris, *rays, any_hit=any_hit)
    ref = kern.intersect_tris_plain(*tris, *rays, any_hit=any_hit)
    torch.cuda.synchronize()
    hit = torch.isfinite(ref[0])
    rec = {'occluded_mismatch': int((torch.isfinite(got[0]) != hit).sum()),
           'hits': int(hit.sum())}
    assert rec['occluded_mismatch'] == 0, (any_hit, rec)
    if any_hit:
        assert got[1] is None and got[2] is None and got[3] is None
        return rec
    pairs = ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3]))
    rec.update(
        idx_mismatch=int((got[1] != ref[1]).sum()),
        max_abs_err=max([float((a[hit] - b[hit]).abs().max())
                         if bool(hit.any()) else 0.0 for a, b in pairs]),
        bit_mismatch=sum(int((a.view(torch.int32)
                              != b.view(torch.int32)).sum())
                         for a, b in pairs))
    assert rec['idx_mismatch'] == 0 and rec['bit_mismatch'] == 0, rec
    rec['idx'] = got[1]
    return rec


def kernel_check(torch, kern, dev, scene, meta):
    """The kernel against its plain version, both on the card."""
    from mitsuba_nlvrl_tpu_torch import sensor as sensor_mod
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions

    key = rng.fold_in(rng.PRNGKey(0), 0)
    pos_key, _ = rng.split(key)
    _, pos01 = film_sample_positions(meta, pos_key, 0, dev)
    cam, _ = sensor_mod.sample_ray(scene, meta, pos01, None)
    g = scene.geo
    box = (g.v0, g.e1, g.e2)
    cam_rays = (cam.o.contiguous(), cam.d.contiguous(),
                cam.mint.contiguous(), cam.maxt.contiguous())

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    def random_rays(N):
        o = rand(N, 3, lo=-3.0, hi=3.0)
        d = rand(N, 3) - o
        d = d / d.norm(dim=1, keepdim=True)
        return (o, d.contiguous(), torch.full((N,), 1e-4, device=dev),
                torch.full((N,), math.inf, device=dev))

    def random_tris(T):
        return (rand(T, 3), rand(T, 3, lo=-0.6, hi=0.6),
                rand(T, 3, lo=-0.6, hi=0.6))

    ties = tuple(torch.cat([x, x]).contiguous() for x in random_tris(300))
    empty = tuple(torch.zeros((0, 3), device=dev) for _ in range(3))
    # the kernel's edges: the whole-set cap and the ring above it, ragged
    # ray tiles, a grid that is one tile short of or over the resident
    # blocks, ray arrays 12 (o, d) and 4 (mint, maxt) bytes off a 16-byte
    # boundary
    cap = WHOLE_SET_CAP
    geo = kern.geometry(1 << 28, 100)
    tile, resident = geo.ray_tile, geo.grid
    ring_grid = kern.geometry(1 << 28, cap + 1).grid
    shifted = tuple(x[1:] for x in random_rays(65537))
    assert shifted[0].data_ptr() % 16 == 12 and shifted[0].is_contiguous()
    cases = {
        'cbox_camera_512': (box, cam_rays),
        'random_1000': (random_tris(1000), random_rays(65536)),
        'random_5000': (random_tris(5000), random_rays(65536)),
        'ties_600': (ties, random_rays(65536)),
        'ragged_n': (random_tris(777), random_rays(100003)),
        'zero_tris': (empty, random_rays(4099)),
        f'whole_cap_{cap}': (random_tris(cap), random_rays(65536)),
        f'ring_{cap + 1}': (random_tris(cap + 1),
                            random_rays(tile * ring_grid + 1)),
        'n_1': (random_tris(300), random_rays(1)),
        'n_255': (random_tris(300), random_rays(255)),
        'n_257': (random_tris(300), random_rays(257)),
        'grid_tiles_minus_1': (random_tris(100),
                               random_rays(tile * resident - 1)),
        'grid_tiles_plus_1': (random_tris(100),
                              random_rays(tile * resident + 1)),
        'misaligned_12b': (random_tris(300), shifted),
    }
    out, worst = {}, 0.0
    for name, (tris, rays) in cases.items():
        for any_hit in (False, True):
            rec = against_plain(torch, kern, tris, rays, any_hit)
            idx = rec.pop('idx', None)
            worst = max(worst, rec.get('max_abs_err', 0.0))
            if name == 'ties_600' and not any_hit:
                # duplicated triangles: the lower copy wins every tie
                assert bool((idx[idx >= 0] < 300).all()), rec
            out[f"{name}{'_any' if any_hit else ''}"] = rec
    return out, worst, box, cam_rays


def record_calls(mnt, scene, meta, mark=None) -> list:
    """One pass (spp 1) of a render, keeping a copy of the triangles and
    rays of every intersection call it makes: [(tris, rays, any_hit)] in
    the order of the calls. ``mark`` (module, function name, list): the
    indices of the calls made inside that function go to the list."""
    from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
    real, calls, inside = pisect.intersect_tris, [], [0]

    def record(v0, e1, e2, o, d, mint, maxt, any_hit=False):
        if inside[0]:
            mark[2].append(len(calls))
        calls.append(((v0, e1, e2), (o.clone(), d.clone(), mint.clone(),
                                     maxt.clone()), any_hit))
        return real(v0, e1, e2, o, d, mint, maxt, any_hit=any_hit)
    pisect.intersect_tris = record
    if mark is not None:
        mod, attr, _ = mark
        real_fn = getattr(mod, attr)

        def marked(*args, **kw):
            inside[0] += 1
            try:
                return real_fn(*args, **kw)
            finally:
                inside[0] -= 1
        setattr(mod, attr, marked)
    try:
        mnt.render(scene, meta, seed=0, spp=1)
    finally:
        pisect.intersect_tris = real
        if mark is not None:
            setattr(mod, attr, real_fn)
    return calls


def render_rays(torch, kern, calls, bw, fl, stride: int = 1,
                fl64: float = None) -> dict:
    """The kernel on a render's own rays: every call of one pass against
    the plain version, every ``stride``-th call timed alone, then the
    pass's calls timed together (device time of the pass's kernel work)
    and its plain version. A float64 scene's calls go to the float64
    kernel, bound at the fp64 rate ``fl64``."""
    recs, worst, bounds = [], 0.0, []
    for k, (tris, rays, any_hit) in enumerate(calls):
        rec = against_plain(torch, kern, tris, rays, any_hit)
        rec.pop('idx', None)
        worst = max(worst, rec.get('max_abs_err', 0.0))
        N, T = rays[0].shape[0], tris[0].shape[0]
        fb = rays[0].element_size()
        _, _, b_bytes, b_ops = bound(N, T, any_hit, bw,
                                     fl64 if fb == 8 else fl, fb)
        bounds.append((b_bytes, b_ops))
        if k % stride:
            continue
        ms = time_ms(lambda: kern.intersect_tris(*tris, *rays,
                                                 any_hit=any_hit), 7, 50)
        recs.append({'call': k, 'any_hit': any_hit, 'rays': N, 'tris': T,
                     'ms': ms, 'bound_ms': max(b_bytes, b_ops),
                     'roofline_share': max(b_bytes, b_ops) / ms, **rec})
    pass_ms = time_ms(lambda: [kern.intersect_tris(*t, *r, any_hit=a)
                               for t, r, a in calls], 7, 5)
    plain_pass_ms = time_ms(
        lambda: [kern.intersect_tris_plain(*t, *r, any_hit=a)
                 for t, r, a in calls], 3, 1)
    n = len(calls)
    bound_ms = sum(max(b) for b in bounds) / n
    return {'launches_per_pass': n,
            'nearest_calls': sum(1 for *_, a in calls if not a),
            'any_hit_calls': sum(1 for *_, a in calls if a),
            'pass_ms': pass_ms, 'ms_per_launch': pass_ms / n,
            'plain_ms_per_launch': plain_pass_ms / n,
            'bound_ms_per_launch': bound_ms,
            'bound_by': ('bytes' if all(b >= o for b, o in bounds)
                         else 'operations'),
            'roofline_share': bound_ms / (pass_ms / n),
            'max_abs_err': worst, 'timed_every': stride, 'calls': recs}


def card_vs_cpu(mnt, compare, desc, spp, scale=None) -> tuple:
    """One scene rendered on the card and on the CPU from one seed: (the
    numbers of ``compare.agreement``, gated against ``scale`` where it is
    given, the CPU's image)."""
    sg, mg = mnt.build_scene(desc)
    sc, mc = mnt.build_scene(desc, device='cpu')
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp)
    img_c, passes_c, rays_c = compare.render_with_passes(sc, mc, 0, spp)
    return compare.agreement(img_g, img_c, passes_c, rays_g, rays_c,
                             scale=scale), img_c


def double_card_vs_cpu(mnt, compare, desc, spp) -> dict:
    """A float64 scene on the card and on the CPU from one seed: the
    numbers of ``compare.agreement``, the images' dtypes, the share of
    pixels within DOUBLE_RTOL and the largest relative pixel error; and
    the same two and the means' relative difference for the card's
    float32 render of the same scene against the CPU's float64 one."""
    import numpy as np
    sg, mg = mnt.build_scene(desc)
    sc, mc = mnt.build_scene(desc, device='cpu')
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp)
    img_c, passes_c, rays_c = compare.render_with_passes(sc, mc, 0, spp)
    s32, m32 = mnt.build_scene({**desc, 'double': False})
    img_32, _, _ = compare.render_with_passes(s32, m32, 0, spp)

    def pixel_rel(img):
        rel = np.abs(img.astype(np.float64) - img_c) / (np.abs(img_c)
                                                        + 1e-12)
        return rel.max(axis=-1)

    rel_g, rel_32 = pixel_rel(img_g), pixel_rel(img_32)
    return {**compare.agreement(img_g, img_c, passes_c, rays_g, rays_c),
            'dtype': str(img_g.dtype), 'cpu_dtype': str(img_c.dtype),
            'pixels_within_rtol': float((rel_g <= DOUBLE_RTOL).mean()),
            'max_pixel_rel': float(rel_g.max()),
            'float32_pixels_within_rtol': float(
                (rel_32 <= DOUBLE_RTOL).mean()),
            'float32_max_pixel_rel': float(rel_32.max()),
            'float32_mean_rel': float(abs(img_32.mean() - img_c.mean())
                                      / abs(img_c.mean()))}


# The CPU halves of the two-pass checks against the CPU (their light pass
# and camera passes on the CPU, 12-46 s each, PERF.md §4) run in one
# spawned worker process beside the card's phases: ``start_cpu_halves``
# submits them, ``nlvrl_card_vs_cpu`` takes its half from there by the
# pickled (description, spp), and computes one in process that was not
# submitted. ``stop_cpu_halves`` ends the worker.
_cpu_pool = None
_cpu_jobs = {}
CPU_WORKER_THREADS = 6      # of the card machine's 8 cores


def _cpu_worker_init() -> None:
    import torch
    torch.set_num_threads(CPU_WORKER_THREADS)


def nlvrl_cpu_half(desc, spp) -> tuple:
    """The CPU's half of ``nlvrl_card_vs_cpu``: (its maps as numpy, their
    counts, the image, the per-pass images, the rays)."""
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.integrators import lighttrace
    from mitsuba_nlvrl_tpu_torch.testing import compare
    sc, mc = mnt.build_scene(desc, device='cpu')
    maps_c = mnt.preprocess(sc, mc, 0)
    img_c, passes_c, rays_c = compare.render_with_passes(sc, mc, 0, spp,
                                                         maps_c)
    return (mnt.maps_to_numpy(maps_c), lighttrace.map_stats(maps_c), img_c,
            passes_c, rays_c)


def start_cpu_halves(jobs) -> None:
    """Submit the CPU halves of ``jobs`` ((description, spp) pairs, in the
    order the phases reach them) to one spawned worker process."""
    global _cpu_pool
    import multiprocessing
    _cpu_pool = multiprocessing.get_context('spawn').Pool(
        1, initializer=_cpu_worker_init)
    for desc, spp in jobs:
        _cpu_jobs[pickle.dumps((desc, spp))] = _cpu_pool.apply_async(
            nlvrl_cpu_half, (desc, spp))


def stop_cpu_halves() -> list:
    """End the worker; returns the submitted halves no check took."""
    global _cpu_pool
    if _cpu_pool is not None:
        _cpu_pool.terminate()
        _cpu_pool.join()
        _cpu_pool = None
    left = list(_cpu_jobs)
    _cpu_jobs.clear()
    return left


def nlvrl_card_vs_cpu(mnt, compare, desc, spp) -> dict:
    """A two-pass scene on the card and on the CPU from one seed: the
    camera passes on the CPU's maps carried to the card (the numbers of
    ``compare.agreement``), and each device on its own maps (their map
    counts and image means)."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.integrators import lighttrace
    job = _cpu_jobs.pop(pickle.dumps((desc, spp)), None)
    maps_np, cpu_maps, img_c, passes_c, rays_c = (
        nlvrl_cpu_half(desc, spp) if job is None else job.get())
    sg, mg = mnt.build_scene(desc)
    maps_g = mnt.preprocess(sg, mg, 0)
    carried = mnt.maps_from_numpy(maps_np, device='cuda')
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp, carried)
    own_g, _, _ = compare.render_with_passes(sg, mg, 0, spp, maps_g)
    own = {'card_maps': lighttrace.map_stats(maps_g),
           'cpu_maps': cpu_maps,
           'card_mean': float(own_g.mean()), 'cpu_mean': float(img_c.mean()),
           'card_finite': bool(np.isfinite(own_g).all()),
           'cpu_half_in_worker': job is not None}
    own['mean_rel'] = abs(own['card_mean'] - own['cpu_mean']) \
        / max(abs(own['cpu_mean']), 1e-12)
    return compare.agreement(img_g, img_c, passes_c, rays_g, rays_c), own


def nlvrl_check_desc(integrator: str, spectral: bool = False) -> dict:
    """The 64x32 NLVRL box of the ``vrl``/``photonmapper`` checks against
    the CPU (and the repaired spectral ``vrl`` check)."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl
    d = cbox_nlvrl(64, 32, spp=2, target_vrls=1000, integrator=integrator)
    if spectral:
        d['spectral'] = True
    return d


def materials_pm_check_desc() -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_materials_pm
    return cbox_materials_pm(64, 32, 2, gather_points_cap=GATHER_CAP,
                             **PM_CHECK_CUTS)


def option_cases() -> tuple:
    """(name, options, HG phase, caps) of ``nlvrl_option_phases``."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        NLVRL_ANISO_OPTIONS, NLVRL_RIS_BRE_OPTIONS)
    return (('nlvrl_aniso', NLVRL_ANISO_OPTIONS, True,
             {'gather_points_cap': GATHER_CAP}),
            ('nlvrl_ris_bre', NLVRL_RIS_BRE_OPTIONS, False,
             {'gather_points_cap': BRE_STEPS, 'max_nl_bends': BRE_BENDS}))


def option_desc(opts, hg, caps, w, h, tv) -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl, hg_phase
    d = cbox_nlvrl(w, h, spp=2, target_vrls=tv, **caps, **opts)
    return hg_phase(d) if hg else d


def cpu_half_jobs() -> list:
    """The two-pass checks against the CPU, in the order the phases reach
    them, each at 2 spp."""
    return [(d, 2) for d in (
        nlvrl_check_desc('vrl'), nlvrl_check_desc('photonmapper'),
        materials_pm_check_desc(),
        *(option_desc(o, hg, c, 64, 32, 1000)
          for _, o, hg, c in option_cases()),
        nlvrl_check_desc('vrl', spectral=True))]


def two_pass_render(torch, mnt, sync, kern, scene, meta, spp):
    """A two-pass render timed by parts: (record, image as numpy); the
    record holds wall, preprocess and camera seconds, rays, Mrays/s,
    kernel launches, host syncs and each camera part's device time."""
    from mitsuba_nlvrl_tpu_torch.testing.nlvrl_probe import (CAMERA_PARTS,
                                                             record_parts)
    torch.cuda.synchronize()
    kern.launches = 0
    sync.host_syncs = 0
    stats, info = [], {}
    with record_parts(timed=True) as plog:
        img = mnt.render(scene, meta, seed=0, spp=spp, ray_stats=stats,
                         info=info)
        torch.cuda.synchronize()
    rays = float(sum(float(r) for r in stats))
    cam_s = info['wall_s'] - info['preprocess_s']
    img_np = img.cpu().numpy()
    return {'wall_s': info['wall_s'], 'preprocess_s': info['preprocess_s'],
            'camera_s': cam_s, 'rays': rays,
            'mrays_per_s': rays / info['wall_s'] / 1e6,
            'launches': kern.launches, 'host_syncs': sync.host_syncs,
            'parts': {p: {'calls': plog.calls(p),
                          'device_s': plog.device_s(p),
                          'share_of_camera': plog.device_s(p) / cam_s}
                      for p in CAMERA_PARTS},
            'shoot_device_s': plog.device_s('shoot'),
            'finite': bool(img.isfinite().all()),
            'mean': float(img_np.mean()), 'shape': list(img_np.shape)}, \
        img_np


def timed_render(torch, mnt, kern, sync, scene, meta, spp) -> tuple:
    """A render timed on the host clock ending in a device synchronise:
    (record with wall seconds, rays, Mrays/s, kernel launches, host syncs,
    the scheduler, finite, mean; the image as numpy)."""
    import numpy as np
    torch.cuda.synchronize()
    kern.launches = 0
    sync.host_syncs = 0
    stats, info, t0 = [], {}, time.time()
    img = mnt.render(scene, meta, seed=0, spp=spp, ray_stats=stats,
                     info=info)
    torch.cuda.synchronize()
    wall = time.time() - t0
    rays = float(sum(float(r) for r in stats))
    img_np = img.cpu().numpy()
    return {'wall_s': wall, 'rays': rays, 'mrays_per_s': rays / wall / 1e6,
            'launches': kern.launches, 'host_syncs': sync.host_syncs,
            'scheduler': info.get('scheduler', 'passes'),
            'finite': bool(np.isfinite(img_np).all()),
            'mean': float(img_np.mean()), 'shape': list(img_np.shape)}, \
        img_np


def materials_phases(torch, mnt, kern, compare, sync, bw, fl) -> dict:
    """The microfacet and plastic BSDFs on the card: ``materials_render_rays``
    (every kernel call of one pass of cbox_materials 512x512, bit for bit
    and timed), ``materials_render`` (16 spp, ``path`` max_depth 8),
    ``materials_card_vs_cpu`` (64x64, 4 spp), ``materials_pm_render``
    (cbox_materials_pm 512x256, 2 spp: the photon mapper's per-photon
    BSDF gathers) and ``materials_pm_card_vs_cpu`` (64x32, 2 spp).
    Returns the renders' launches and the kernel's numbers on the pass."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.integrators import photon_est
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (MATERIALS,
                                                        cbox_materials,
                                                        cbox_materials_pm)
    scene, meta = mnt.build_scene(cbox_materials(512, 512, 16))
    calls = record_calls(mnt, scene, meta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'materials_render_rays', **own})
    del calls
    rec, img_np = timed_render(torch, mnt, kern, sync, scene, meta, 16)
    launches = rec['launches']
    emit({'phase': 'materials_render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'bsdfs': {k: v['type'] for k, v in MATERIALS.items()}, **rec})
    assert 0 < launches <= 16 * 8 * 2, launches
    assert np.isfinite(img_np).all() and img_np.shape == (512, 512, 3)
    assert 0.01 < float(img_np.mean()) < 10.0, img_np.mean()
    agree, _ = card_vs_cpu(mnt, compare, cbox_materials(64, 64, 4), 4)
    emit({'phase': 'materials_card_vs_cpu', 'res': 64, 'spp': 4, **agree})
    compare.check(agree)

    pscene, pmeta = mnt.build_scene(cbox_materials_pm(
        512, 256, 2, gather_points_cap=GATHER_CAP))
    assert not photon_est._gather_diffuse_only(pmeta)
    rec, pimg = two_pass_render(torch, mnt, sync, kern, pscene, pmeta, 2)
    emit({'phase': 'materials_pm_render', 'res': [512, 256], 'spp': 2,
          'integrator': 'photonmapper', 'gather_points_cap': GATHER_CAP,
          **rec})
    assert rec['launches'] > 0 and rec['parts']['surface_gather']['calls']
    assert rec['finite'] and pimg.shape == (256, 512, 3)
    assert 0.0 < rec['mean'] < 10.0, rec['mean']
    agree, own_maps = nlvrl_card_vs_cpu(mnt, compare,
                                        materials_pm_check_desc(), 2)
    emit({'phase': 'materials_pm_card_vs_cpu', 'res': [64, 32], 'spp': 2,
          'cuts': PM_CHECK_CUTS, **agree, 'own_maps': own_maps})
    compare.check(agree)
    assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, own_maps
    return {'launches_materials': launches,
            'launches_materials_pm': rec['launches'],
            'materials_ms': own['ms_per_launch'],
            'materials_plain_ms': own['plain_ms_per_launch'],
            'materials_bound_ms': own['bound_ms_per_launch'],
            'max_abs_err': own['max_abs_err']}


def nlvrl_option_phases(torch, mnt, kern, compare, sync, bw, fl) -> dict:
    """The thesis's options on the NLVRL box at full width (512x256, 2
    spp, 8,000 VRLs; the caps cut to GATHER_CAP, BRE_STEPS and BRE_BENDS):
    ``cbox_nlvrl_aniso`` (HG g = 0.8, the tabulated
    anisotropic camera CDF, 4-fold dicing, lengthened VRLs: its preprocess,
    every kernel call of one render with the long_vrl call marked, checked
    and timed alone, the render, 64x32 card against CPU) and
    ``cbox_nlvrl_ris_bre`` (RIS VRL selection and the beam radiance
    estimate: the render, 64x32 card against CPU). Returns the renders'
    launches and the kernel's numbers."""
    from mitsuba_nlvrl_tpu_torch.integrators import lighttrace
    from mitsuba_nlvrl_tpu_torch.integrators import vrl as vrl_mod
    out = {}
    for name, opts, hg, caps in option_cases():
        def desc(w, h, tv):
            return option_desc(opts, hg, caps, w, h, tv)
        scene, meta = mnt.build_scene(desc(512, 256, 8000))
        torch.cuda.synchronize()
        kern.launches = 0
        sync.host_syncs = 0
        t0 = time.time()
        maps = mnt.preprocess(scene, meta, 0)
        torch.cuda.synchronize()
        emit({'phase': f'{name}_preprocess', 'options': opts, 'cuts': caps,
              'hg_g': 0.8 if hg else None, 'wall_s': time.time() - t0,
              'launches': kern.launches, 'host_syncs': sync.host_syncs,
              'vrl_rows': maps.vrl_o.shape[0],
              **lighttrace.map_stats(maps)})
        assert int(maps.vrl_count) > 0
        del maps
        if opts.get('long_vrl'):
            # one render's calls, the long_vrl call among them
            marked = []
            calls = record_calls(mnt, scene, meta,
                                 mark=(vrl_mod, '_lengthen_vrls', marked))
            assert len(marked) == 1, marked
            own = render_rays(torch, kern, calls, bw, fl,
                              stride=max(1, len(calls) // 64))
            tris, rays, any_hit = calls[marked[0]]
            lrec = against_plain(torch, kern, tris, rays, any_hit)
            lrec.pop('idx', None)
            N, T = rays[0].shape[0], tris[0].shape[0]
            _, _, b_bytes, b_ops = bound(N, T, any_hit, bw, fl)
            lms = time_ms(lambda: kern.intersect_tris(*tris, *rays), 7, 50)
            lplain = time_ms(lambda: kern.intersect_tris_plain(*tris, *rays),
                             5, 3)
            long_call = {'call': marked[0], 'rays': N, 'tris': T, 'ms': lms,
                         'plain_ms': lplain, 'bound_ms': max(b_bytes, b_ops),
                         'bound_by': ('bytes' if b_bytes >= b_ops
                                      else 'operations'), **lrec}
            emit({'phase': f'{name}_render_rays', **own,
                  'long_vrl_call': long_call})
            del calls
            out.update({'long_vrl': long_call, f'{name}_rays': own})
        rec, img = two_pass_render(torch, mnt, sync, kern, scene, meta, 2)
        emit({'phase': f'{name}_render', 'res': [512, 256], 'spp': 2,
              'target_vrls': 8000, 'options': opts, **rec})
        assert rec['launches'] > 0 and rec['finite'], rec
        assert img.shape == (256, 512, 3) and 0.0 < rec['mean'] < 10.0
        if opts.get('use_bre'):
            assert rec['parts']['beam']['calls'] > 0
            assert rec['parts']['volume_gather']['calls'] == 0
        out[f'launches_{name}'] = rec['launches']
        agree, own_maps = nlvrl_card_vs_cpu(mnt, compare,
                                            desc(64, 32, 1000), 2)
        emit({'phase': f'{name}_card_vs_cpu', 'res': [64, 32], 'spp': 2,
              **agree, 'own_maps': own_maps})
        compare.check(agree)
        assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, \
            own_maps
    return out


def item7_phases(torch, mnt, kern, compare, sync, bw, fl, workdir) -> dict:
    """Textures, the wrapper BSDFs, the remaining lights, samplers and
    sensors, direct/depth and instancing on the card: ``textured_build``,
    ``textured_render_rays`` (every kernel call of one pass of
    cbox_textured 512x512, bit for bit and timed), ``textured_render`` (16
    spp, ``path`` max_depth 8, in process), ``textured_cli`` (the CLI on
    the same scene file: its EXR equal to the in-process render);
    ``env_render_rays`` and ``env_render`` (env_spheres 512x512, 16 spp,
    built in process); then ``item7_checks``. Returns the renders'
    launches and the kernel's numbers on their passes."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cbox_textured,
                                                        env_spheres)
    from mitsuba_nlvrl_tpu_torch.utils.io import read_exr
    out = {}

    # --- cbox_textured: a scene file with bitmaps, 512x512, 16 spp ------
    t0 = time.time()
    path = cbox_textured(os.path.join(workdir, 'textured'), spp=16,
                         res=512, max_depth=8)
    scene, meta = mnt.build_scene(load_file(path))
    torch.cuda.synchronize()
    emit({'phase': 'textured_build', 'seconds': time.time() - t0,
          'n_tris': meta.n_tris, 'n_spheres': meta.n_spheres,
          'bsdf_types': list(meta.bsdf_types),
          'emitter_types': list(meta.emitter_types),
          'sampler': meta.sampler, 'sensor_type': meta.sensor_type,
          'textures': int(scene.textures.type.shape[0]),
          'bitmap_texels': list(scene.textures.data.shape)})
    assert meta.n_tris < WHOLE_SET_CAP and meta.has_param_textures
    calls = record_calls(mnt, scene, meta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'textured_render_rays', **own})
    del calls
    rec, img_np = timed_render(torch, mnt, kern, sync, scene, meta, 16)
    emit({'phase': 'textured_render', 'res': 512, 'spp': 16,
          'max_depth': 8, 'scene': 'cbox_textured', **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert img_np.shape == (512, 512, 3) and 0.01 < rec['mean'] < 10.0
    exr = os.path.join(workdir, 'textured.exr')
    wall, cli_out = run_cli([path, '-o', exr, '-v'], timeout=400)
    stats = json.loads([x for x in cli_out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    im, names = read_exr(exr)
    cli_img = im[..., [names.index(c) for c in 'RGB']]
    emit({'phase': 'textured_cli', 'process_wall_s': wall,
          'render_s': stats['render_s'], 'rays': stats['rays'],
          'mrays_per_s': stats['mrays_per_s'],
          'launches': stats['kernel_launches'],
          'host_syncs': stats['host_syncs'],
          'bit_equal_in_process': cli_img.tobytes() == img_np.tobytes(),
          'finite': bool(np.isfinite(cli_img).all()),
          'mean': float(cli_img.mean())})
    # the same scene file, seed and device: the same image in every bit
    assert cli_img.tobytes() == img_np.tobytes(), \
        "the CLI's EXR differs from the in-process render"
    assert stats['rays'] == rec['rays']
    out.update(launches_textured=rec['launches'],
               launches_textured_cli=stats['kernel_launches'],
               textured_ms=own['ms_per_launch'],
               textured_plain_ms=own['plain_ms_per_launch'],
               textured_bound_ms=own['bound_ms_per_launch'],
               max_abs_err=own['max_abs_err'])
    del scene

    # --- env_spheres: built in process, 512x512, 16 spp ---------------
    t0 = time.time()
    escene, emeta = mnt.build_scene(env_spheres(os.path.join(workdir, 'env'),
                                                512, 512, 16))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    calls = record_calls(mnt, escene, emeta)
    eown = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'env_render_rays', 'build_s': build_s,
          'n_tris': emeta.n_tris, 'env_map': list(
              escene.emitters.env_map.shape),
          'warp_levels': len(escene.emitters.env_warp.levels), **eown})
    del calls
    rec, eimg = timed_render(torch, mnt, kern, sync, escene, emeta, 16)
    emit({'phase': 'env_render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'scene': 'env_spheres', **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert eimg.shape == (512, 512, 3) and 0.01 < rec['mean'] < 10.0
    out.update(launches_env=rec['launches'], env_ms=eown['ms_per_launch'],
               env_plain_ms=eown['plain_ms_per_launch'],
               env_bound_ms=eown['bound_ms_per_launch'],
               max_abs_err=max(out['max_abs_err'], eown['max_abs_err']))
    del escene

    item7_checks(torch, mnt, compare, workdir)
    return out


def item7_checks(torch, mnt, compare, workdir) -> None:
    """Slice 7 on the card against the CPU (``compare.check`` on each):
    cbox_textured and env_spheres at 64x64, 4 spp, direct and depth at
    64x64, the radiance and irradiance meters on a 1x1 film, a 64x32
    photon-mapper box lit by a spot and a directional light on the CPU's
    maps; and film_jitter of the five samplers at 512x512, spp 7 and 16,
    equal in bits, with the card's host reads of the cycle walk."""
    from mitsuba_nlvrl_tpu_torch.core import rng, sync
    from mitsuba_nlvrl_tpu_torch.sampler import film_jitter
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        cbox_spot_directional, cbox_textured, cornell_box, env_spheres)

    def meter(kind):
        d = cornell_box(spp=64, res=1)
        d['sensor'] = dict(d['sensor'], type=kind)
        return d
    checks = (
        ('cbox_textured', load_file(cbox_textured(
            os.path.join(workdir, 'textured64'), spp=4, res=64)), 4),
        ('env_spheres', env_spheres(os.path.join(workdir, 'env64'), 64, 64,
                                    4), 4),
        ('direct', cornell_box(spp=4, res=64,
                               integrator={'type': 'direct'}), 4),
        ('depth', cornell_box(spp=2, res=64,
                              integrator={'type': 'depth'}), 2),
        ('radiancemeter', meter('radiancemeter'), 64),
        ('irradiancemeter', meter('irradiancemeter'), 64))
    for name, desc, spp in checks:
        agree, _ = card_vs_cpu(mnt, compare, desc, spp)
        emit({'phase': 'item7_checks', 'check': name, 'spp': spp, **agree})
        compare.check(agree)
    agree, own_maps = nlvrl_card_vs_cpu(mnt, compare,
                                        cbox_spot_directional(64, 32, 2), 2)
    emit({'phase': 'item7_checks', 'check': 'photonmapper_spot_directional',
          'res': [64, 32], 'spp': 2, **agree, 'own_maps': own_maps})
    compare.check(agree)
    assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, own_maps
    # the card's host reads are those of the Kensler cycle walk (spp 7:
    # multijitter over 7, orthogonal over 9 and 3; spp 16: orthogonal
    # over 25 and 5)
    N, same, reads = 512 * 512, {}, {}
    for sampler in ('independent', 'stratified', 'multijitter', 'ldsampler',
                    'orthogonal'):
        for spp in (7, 16):
            for p in (0, spp - 1):
                key = rng.fold_in(rng.PRNGKey(0), p)
                before = sync.host_syncs
                g = film_jitter(sampler, key, p, spp, N,
                                torch.device('cuda')).cpu().numpy()
                reads[f'{sampler}/{spp}/{p}'] = sync.host_syncs - before
                c = film_jitter(sampler, key, p, spp, N,
                                torch.device('cpu')).numpy()
                same[f'{sampler}/{spp}/{p}'] = g.tobytes() == c.tobytes()
    emit({'phase': 'item7_checks', 'check': 'film_jitter_bits', 'res': 512,
          'equal': same, 'card_walk_reads': reads})
    assert all(same.values()), same
    assert reads['multijitter/7/0'] > 0 and reads['orthogonal/16/0'] > 0, \
        reads


def item8_phases(torch, mnt, kern, compare, sync, bw, fl, workdir,
                 pass_loop) -> dict:
    """Spectral and polarized transport, the wrapper integrators and the
    regeneration scheduler on the card: ``spectral_render_rays``,
    ``spectral_render`` and ``spectral_cli`` (cbox_spectral 512x512, 16
    spp, ``path`` max_depth 8, the reference cbox.xml's light SPD and a
    named conductor whose curves the phase writes into ``MNT_IOR_DIR``;
    the CLI's ``--spectral`` EXR equal in bits to the in-process render);
    ``polarized_render_rays`` and ``polarized_render`` (cbox_polarized
    512x512, 16 spp, ``stokes`` around ``path`` max_depth 8, components 0
    and 1, then spectral, component 3); ``regen_render_rays`` and
    ``regen_render`` (hetvol_volpath under ``MNT_REGEN=1``, beside the
    pass loop's render of the same scene, ``pass_loop``); then
    ``item8_checks``. Returns the renders' launches and the kernel's
    numbers on their passes."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        SPECTRAL_CONDUCTOR, cbox_polarized, cbox_spectral, hetvol_box,
        with_component)
    from mitsuba_nlvrl_tpu_torch.utils.io import read_exr
    out = {'max_abs_err': 0.0}

    def kernel_numbers(tag, own):
        out.update({f'{tag}_ms': own['ms_per_launch'],
                    f'{tag}_plain_ms': own['plain_ms_per_launch'],
                    f'{tag}_bound_ms': own['bound_ms_per_launch'],
                    f'{tag}_bound_by': own['bound_by']})
        out['max_abs_err'] = max(out['max_abs_err'], own['max_abs_err'])

    # --- cbox_spectral: a scene file, 512x512, 16 spp ------------------
    sdir = os.path.join(workdir, 'spectral')
    path = cbox_spectral(sdir, spp=16, res=512, max_depth=8)
    os.environ['MNT_IOR_DIR'] = sdir
    t0 = time.time()
    desc = load_file(path)
    desc['spectral'] = True
    scene, meta = mnt.build_scene(desc)
    torch.cuda.synchronize()
    assert meta.spectral and meta.has_conductor_spd
    calls = record_calls(mnt, scene, meta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'spectral_render_rays', 'build_s': time.time() - t0,
          'n_tris': meta.n_tris, 'conductor_curves': list(
              scene.conductor_spd.shape), **own})
    del calls
    kernel_numbers('spectral', own)
    rec, img_np = timed_render(torch, mnt, kern, sync, scene, meta, 16)
    emit({'phase': 'spectral_render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'scene': 'cbox_spectral', **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert img_np.shape == (512, 512, 3) and 0.01 < rec['mean'] < 10.0
    exr = os.path.join(workdir, 'spectral.exr')
    wall, cli_out = run_cli([path, '-o', exr, '--spectral', '-v'],
                            timeout=400)
    stats = json.loads([x for x in cli_out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    im, names = read_exr(exr)
    cli_img = im[..., [names.index(c) for c in 'RGB']]
    emit({'phase': 'spectral_cli', 'process_wall_s': wall,
          'render_s': stats['render_s'], 'rays': stats['rays'],
          'mrays_per_s': stats['mrays_per_s'],
          'launches': stats['kernel_launches'],
          'host_syncs': stats['host_syncs'],
          'bit_equal_in_process': cli_img.tobytes() == img_np.tobytes(),
          'mean': float(cli_img.mean())})
    assert cli_img.tobytes() == img_np.tobytes(), \
        "the CLI's spectral EXR differs from the in-process render"
    assert stats['rays'] == rec['rays']
    out.update(launches_spectral=rec['launches'],
               launches_spectral_cli=stats['kernel_launches'])
    del scene

    # --- cbox_polarized: stokes, 512x512, 16 spp ------------------------
    pscene, pmeta = mnt.build_scene(cbox_polarized(
        512, 16, 0, conductor=SPECTRAL_CONDUCTOR, max_depth=CUT_DEPTH))
    calls = record_calls(mnt, pscene, pmeta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'polarized_render_rays', 'n_tris': pmeta.n_tris,
          'bsdf_types': list(pmeta.bsdf_types), **own})
    del calls
    kernel_numbers('polarized', own)
    out['launches_polarized'] = 0
    for c in (0, 1):
        rec, pimg = timed_render(torch, mnt, kern, sync, pscene,
                                 with_component(pmeta, c), 16)
        emit({'phase': 'polarized_render', 'res': 512, 'spp': 16,
              'max_depth': CUT_DEPTH, 'component': c, 'spectral': False,
              **rec})
        assert rec['launches'] > 0 and rec['finite'], rec
        assert (0.01 < rec['mean'] < 10.0) if c == 0 \
            else float(np.abs(pimg).max()) > 1e-3
        out['launches_polarized'] += rec['launches']
    del pscene
    sdesc = cbox_polarized(512, 16, 3, spectral=True,
                           conductor=SPECTRAL_CONDUCTOR, max_depth=CUT_DEPTH)
    pscene, pmeta = mnt.build_scene(sdesc)
    assert pmeta.spectral and pmeta.has_conductor_spd
    calls = record_calls(mnt, pscene, pmeta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'polarized_render_rays', 'spectral': True, **own})
    del calls
    kernel_numbers('spectral_polarized', own)
    rec, pimg = timed_render(torch, mnt, kern, sync, pscene, pmeta, 16)
    emit({'phase': 'polarized_render', 'res': 512, 'spp': 16,
          'max_depth': CUT_DEPTH, 'component': 3, 'spectral': True, **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert float(np.abs(pimg).max()) > 1e-3
    out['launches_spectral_polarized'] = rec['launches']
    del pscene

    # --- hetvol_volpath through the regeneration scheduler ---------------
    os.environ['MNT_REGEN'] = '1'
    try:
        vscene, vmeta = mnt.build_scene(hetvol_box(768, 576, spp=2,
                                                   grid_res=128, seed=0,
                                                   scale=100.0))
        calls = record_calls(mnt, vscene, vmeta)
        own = render_rays(torch, kern, calls, bw, fl,
                          stride=max(1, len(calls) // 64))
        emit({'phase': 'regen_render_rays', **own})
        del calls
        kernel_numbers('regen', own)
        rec, _ = timed_render(torch, mnt, kern, sync, vscene, vmeta, 2)
        emit({'phase': 'regen_render', 'res': [768, 576], 'spp': 2,
              'scene': 'hetvol_volpath', **rec, 'pass_loop': pass_loop,
              'wall_vs_pass_loop': rec['wall_s'] / pass_loop['wall_s'],
              'rays_vs_pass_loop': rec['rays'] / pass_loop['rays']})
        assert rec['scheduler'] == 'regen' and rec['finite'], rec
        assert rec['launches'] > 0 and 0.01 < rec['mean'] < 10.0, rec
        out['launches_regen'] = rec['launches']
        del vscene
    finally:
        del os.environ['MNT_REGEN']

    item8_checks(torch, mnt, compare, workdir)
    return out


def item8_checks(torch, mnt, compare, workdir) -> None:
    """Slice 8 on the card against the CPU (``compare.check`` on each, at
    64x64): cbox_spectral; cbox_polarized components 0 and 1 and its
    spectral component 3 (S1 and S3 gated against S0); ``aov`` with
    sh_normal, position and uv; ``moment`` around ``path``; a
    heterogeneous box with an albedo gridvolume; regeneration on a
    homogeneous-fog box (card regen against CPU regen). Then regeneration
    against the pass loop on the card (a 64x64 heterogeneous box, 4 spp):
    on two seeds the reference's noise rule (the gap between the
    schedulers' images under 1.5 times the seed-to-seed noise, the means
    within 8%); on four, with the regeneration's film jitter salted by
    the seed, the means within 6 standard errors over seeds."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.integrators import regen as regen_mod
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        SPECTRAL_CONDUCTOR, albedo_grid_medium, cbox_polarized,
        cbox_spectral, cornell_box, hetvol_box)

    def gate(name, desc, spp, scale=None):
        agree, img_c = card_vs_cpu(mnt, compare, desc, spp, scale)
        emit({'phase': 'item8_checks', 'check': name, 'spp': spp, **agree})
        compare.check(agree)
        return img_c

    desc = load_file(cbox_spectral(os.path.join(workdir, 'spectral64'),
                                   spp=4, res=64, max_depth=8))
    desc['spectral'] = True
    gate('cbox_spectral', desc, 4)
    s0 = gate('cbox_polarized_s0', cbox_polarized(
        64, 2, 0, conductor=SPECTRAL_CONDUCTOR), 2)
    gate('cbox_polarized_s1', cbox_polarized(
        64, 2, 1, conductor=SPECTRAL_CONDUCTOR), 2, scale=s0)
    s0 = gate('cbox_spectral_polarized_s0', cbox_polarized(
        64, 2, 0, spectral=True, conductor=SPECTRAL_CONDUCTOR), 2)
    gate('cbox_spectral_polarized_s3', cbox_polarized(
        64, 2, 3, spectral=True, conductor=SPECTRAL_CONDUCTOR), 2,
        scale=s0)
    for kind in ('sh_normal', 'position', 'uv'):
        gate(f'aov_{kind}', cornell_box(spp=2, res=64, integrator={
            'type': 'aov', 'aovs': f'x:{kind}'}), 2,
            scale=np.ones((64, 64, 3)))
    gate('moment_path', cornell_box(spp=4, res=64, integrator={
        'type': 'moment', 'integrator': {'type': 'path', 'max_depth': 8}}),
        4)
    gate('albedo_grid', cornell_box(
        spp=2, res=64, medium=albedo_grid_medium(16, scale=5.0),
        integrator={'type': 'volpath', 'max_depth': CUT_DEPTH}), 2)
    fog = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.9}
    os.environ['MNT_REGEN'] = '1'
    try:
        gate('regen_fog', cornell_box(
            spp=2, res=64, medium=fog,
            integrator={'type': 'volpath', 'max_depth': 8}), 2)
        # regeneration against the pass loop on the card (the noise rule
        # of the reference's tests/test_regen.py), on a thinner medium:
        # the pass loop's small passes drain to their slowest walk (156 s
        # for 16 spp at sigma_t x100, 110 s for 2 x 8 spp at x20 and the
        # schedulers beside, on an H100)
        scene, meta = mnt.build_scene(hetvol_box(64, 64, spp=4,
                                                 grid_res=32, seed=0,
                                                 scale=5.0,
                                                 max_depth=CUT_DEPTH))
        seeds = (1, 2, 3, 4)

        def images(mode, seeds):
            os.environ['MNT_REGEN'] = mode
            return np.stack([mnt.render(scene, meta, seed=s,
                                        spp=4).cpu().numpy() for s in seeds])
        loop = images('0', seeds)
        regen = images('1', seeds[:2])
        # the regeneration film jitter is a function of (pass, pixel)
        # alone, in the reference as here, so its film positions do not
        # move with the seed: across seeds its image keeps one fixed
        # sampling error at the light's edges (about 5% of the mean at
        # this size), and seeds cannot bound the schedulers' gap. With
        # the pass index salted by the seed each seed draws its own
        # positions, and the means must agree within 6 standard errors
        # over seeds (the rule of the reference's homogeneous-fog test)
        real = regen_mod.lane_jitter
        try:
            salted = []
            for s in seeds:
                regen_mod.lane_jitter = \
                    lambda t, pss, pix, s=s: real(t, pss + 4096 * s, pix)
                salted.append(images('1', (s,))[0])
        finally:
            regen_mod.lane_jitter = real
        salted = np.stack(salted)
    finally:
        del os.environ['MNT_REGEN']
    noise = float(np.abs(loop[0] - loop[1]).mean())
    cross = float(np.abs(regen.mean(0) - loop[:2].mean(0)).mean())
    rel = float(abs(regen.mean() - loop[:2].mean()) / loop[:2].mean())
    m_loop, m_salt = loop.mean(axis=(1, 2, 3)), salted.mean(axis=(1, 2, 3))
    se = float(np.sqrt(m_loop.var(ddof=1) / len(seeds)
                       + m_salt.var(ddof=1) / len(seeds)))
    gap = float(m_salt.mean() - m_loop.mean())
    emit({'phase': 'item8_checks', 'check': 'regen_vs_pass_loop',
          'scene': 'hetvol_box 64x64, sigma_t x5', 'spp': 4,
          'seeds': list(seeds[:2]),
          'noise': noise, 'cross': cross, 'mean_rel': rel,
          'salted_seeds': list(seeds), 'salted_gap': gap,
          'salted_rel': gap / float(m_loop.mean()), 'salted_se': se,
          'salted_z': gap / se})
    assert np.isfinite(regen).all() and cross < 1.5 * noise, (cross, noise)
    assert rel < 0.08, rel
    assert np.isfinite(salted).all() and abs(gap) < 6 * se, (gap, se)


# slice 9: the inverse-rendering loop's Adam steps, and the grid of the
# volumetric gradient's configuration
AD_STEPS = 8
AD_GRID_RES = 128
# the heterogeneous gradient's depth: its diff bounce loop runs
# min(192, max(8, 3 * max_depth)) trips, and at max_depth 8 the backward
# pass took 74-79 s on an H100, the script over its limit (PERF.md §4)
AD_DEPTH = 3
# the heterogeneous box's depth in the card-against-CPU gradient check
AD_CHECK_DEPTH = 3


class diff_step_check:
    """Every kernel call made inside the block, in the forward pass and in
    the backward pass's recompute alike, held against the plain version on
    the same inputs as it is made: t, u, v equal in bits and idx equal for
    a nearest hit, the occlusion for an any hit. The mismatches add up on
    the card (no host read a call); ``done()`` reads them once."""

    def __init__(self, torch, kern):
        self.torch, self.kern = torch, kern
        self.calls = {'forward': 0, 'recompute': 0}

    def __enter__(self):
        from mitsuba_nlvrl_tpu_torch.core import counters
        from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
        torch, kern = self.torch, self.kern
        self.mismatch = 0
        self.pisect, self.real = pisect, pisect.intersect_tris

        def checked(v0, e1, e2, o, d, mint, maxt, any_hit=False):
            got = self.real(v0, e1, e2, o, d, mint, maxt, any_hit=any_hit)
            ref = kern.intersect_tris_plain(v0, e1, e2, o, d, mint, maxt,
                                            any_hit=any_hit)
            self.calls['recompute' if counters.recomputing
                       else 'forward'] += 1
            bad = (torch.isfinite(got[0]) != torch.isfinite(ref[0])).sum()
            if not any_hit:
                bad = bad + (got[1] != ref[1]).sum() + sum(
                    (a.view(torch.int32) != b.view(torch.int32)).sum()
                    for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                                 (got[3], ref[3])))
            self.mismatch += bad
            return got
        pisect.intersect_tris = checked
        return self

    def __exit__(self, *exc):
        self.pisect.intersect_tris = self.real

    def done(self) -> dict:
        rec = {'calls_forward': self.calls['forward'],
               'calls_recompute': self.calls['recompute'],
               'bit_mismatch': int(self.mismatch)}
        assert rec['bit_mismatch'] == 0, rec
        assert rec['calls_forward'] > 0 and rec['calls_recompute'] > 0, rec
        return rec


def ad_counts(kern, sync) -> dict:
    return {'launches': kern.launches,
            'launches_recompute': kern.launches_recompute,
            'host_syncs': sync.host_syncs,
            'host_syncs_recompute': sync.host_syncs_recompute}


def path_grad_phase(torch, mnt, kern, sync) -> dict:
    """``cbox_path_grad``: the inverse-rendering loop of tests/test_api.py
    at the cbox_path configuration's width (the 512x512 Cornell box,
    ``path`` max_depth 8). The target is a 1 spp render of seed 3; the
    BSDF parameters start at 0.3 times their values; AD_STEPS Adam steps
    (lr 0.05), each a 1 spp differentiable render and its backward pass.
    One diff step is first checked call by call (``diff_step_check``).
    Prints every step's loss, forward and backward seconds, launches and
    host syncs (forward and recompute apart), and the peak memory; holds
    the last loss below the first and every gradient finite."""
    from mitsuba_nlvrl_tpu_torch import autodiff as ad
    from mitsuba_nlvrl_tpu_torch.core import counters
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box

    scene, meta = mnt.build_scene(cornell_box(
        spp=1, res=512, integrator={'type': 'path', 'max_depth': 8}))
    pm = ad.traverse(scene).keep(['bsdfs.params'])
    with torch.no_grad():
        target = ad.render(scene, meta, spp=1, seed=3)
    opt = ad.Adam(pm, lr=0.05)
    opt.params = {'bsdfs.params': pm['bsdfs.params'] * 0.3}

    def loss_of():
        img = ad.render(scene, meta, params=opt.params, pmap=pm, spp=1,
                        seed=3)
        return ((img - target) ** 2).mean()

    # one diff step checked call by call (also the warm-up)
    with diff_step_check(torch, kern) as chk:
        loss_of().backward()
        torch.cuda.synchronize()
    check = chk.done()
    opt.zero_grad()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    steps, t_all = [], time.time()
    for _ in range(AD_STEPS):
        c0 = ad_counts(kern, sync)
        t0 = time.time()
        loss = loss_of()
        torch.cuda.synchronize()
        t1 = time.time()
        c1 = ad_counts(kern, sync)
        opt.zero_grad()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.time()
        c2 = ad_counts(kern, sync)
        grad = opt.params['bsdfs.params'].grad
        finite = bool(grad.isfinite().all())
        opt.step()
        steps.append({'loss': float(loss), 'forward_s': t1 - t0,
                      'backward_s': t2 - t1, 'grad_finite': finite,
                      'grad_abs_sum': float(grad.abs().sum()),
                      **{f'forward_{k}': c1[k] - c0[k] for k in c0},
                      **{f'backward_{k}': c2[k] - c1[k] for k in c0}})
    torch.cuda.synchronize()
    wall = time.time() - t_all
    counts = ad_counts(kern, sync)
    rec = {'res': 512, 'spp': 1, 'max_depth': 8, 'steps': AD_STEPS,
           'lr': 0.05, 'wall_s': wall, 'losses': [s['loss'] for s in steps],
           'peak_memory_gib': torch.cuda.max_memory_allocated() / 2**30,
           **counts, 'step_records': steps, 'check': check}
    emit({'phase': 'cbox_path_grad', **rec})
    assert counts['launches'] > 0 and counts['launches_recompute'] > 0, \
        counts
    assert all(s['grad_finite'] for s in steps), steps
    assert rec['losses'][-1] < rec['losses'][0], rec['losses']
    return rec


def hetvol_grad_phase(torch, mnt, kern, sync) -> dict:
    """``hetvol_volpath_grad``: the gradient of the mean image of the
    hetvol_volpath configuration (``hetvol_box`` 768x576, a 128^3 grid,
    sigma_t x100, ``volpath``; cut to 1 spp from the cell's 2 and to
    max_depth AD_DEPTH from 8) with respect to ``media.grid_sigma_t``,
    every kernel call of the diff step checked as it is made, then one
    SGD step through the
    ``ParameterMap`` (``with_sigma_grid`` refreshes the derived arrays).
    Prints wall seconds (forward, backward and the step apart), peak
    memory, launches and host syncs, and the voxels with a nonzero
    gradient."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import autodiff as ad
    from mitsuba_nlvrl_tpu_torch.core import counters
    from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box

    scene, meta = mnt.build_scene(hetvol_box(
        768, 576, spp=1, grid_res=AD_GRID_RES, seed=0, scale=100.0,
        max_depth=AD_DEPTH))
    pm = ad.traverse(scene).keep(['media.grid_sigma_t'])
    opt = ad.SGD(pm, lr=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    with diff_step_check(torch, kern) as chk:
        t0 = time.time()
        img = ad.render(scene, meta, params=opt.params, pmap=pm, spp=1,
                        seed=0)
        loss = img.mean()
        torch.cuda.synchronize()
        t1 = time.time()
        c1 = ad_counts(kern, sync)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.time()
    counts = ad_counts(kern, sync)
    check = chk.done()
    grid0 = pm['media.grid_sigma_t'].clone()
    grad = opt.params['media.grid_sigma_t'].grad.clone()
    t3 = time.time()
    opt.step()
    updated = opt.update_scene()
    torch.cuda.synchronize()
    t4 = time.time()
    nonzero = int((grad != 0).sum())
    med = updated.media
    rec = {'res': [768, 576], 'spp': 1, 'grid_res': AD_GRID_RES,
           'sigma_t_scale': 100.0, 'max_depth': AD_DEPTH,
           'bounce_trips_bound': min(192, max(8, 3 * AD_DEPTH)),
           'walk_events_bound': 192,
           'forward_s': t1 - t0, 'backward_s': t2 - t1,
           'sgd_step_s': t4 - t3, 'mean': float(loss),
           'peak_memory_gib': torch.cuda.max_memory_allocated() / 2**30,
           **counts,
           **{f'forward_{k}': c1[k] for k in c1},
           'nonzero_voxels': nonzero, 'voxels': grad.numel(),
           'grad_finite': bool(grad.isfinite().all()),
           'grad_abs_sum': float(grad.abs().sum()), 'check': check}
    emit({'phase': 'hetvol_volpath_grad', **rec})
    assert counts['launches'] > 0 and counts['launches_recompute'] > 0, \
        counts
    assert rec['grad_finite'] and nonzero > 0, rec
    assert bool(img.isfinite().all()) and 0.0 < rec['mean'] < 10.0, rec
    # the step went through with_sigma_grid: a new grid, its bounds and
    # its packed rows refreshed
    assert torch.equal(med.grid_sigma_t, grid0 - grad)
    assert med.grid_sigma_p8 is not None and not med.grid_sigma_t.requires_grad
    assert bool((med.grid_sup.amax() >= med.grid_sigma_t.amax()).item())
    return rec


def autodiff_checks(torch, mnt) -> None:
    """The card's gradients against the CPU's on reduced scenes: the
    Cornell box at 64x64 (``path`` max_depth 8: bsdfs.params and
    emitters.params) and ``hetvol_box`` at 24x24 with a 16^3 grid
    (sigma_t x20 as in the CPU parity tests, ``volpath`` at the CPU
    test's max_depth 3, AD_CHECK_DEPTH; media.params,
    media.grid_sigma_t), each the gradient of sum(image * W) for a seeded
    W. The images agree within 1e-5 relative. Each gradient entry is held
    to the CPU tests' tolerance (1e-4 relative plus 1e-6 or 1e-5); the
    card's transcendentals differ from the CPU's by ulps, so a lane whose
    walk turns on one takes another decision, and as the render gates
    allow such lanes, at most one entry in a thousand (and one at least)
    may fall outside, their error summing to 1e-4 of the gradient's
    absolute sum at most."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import autodiff as ad
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box, hetvol_box

    cases = (
        ('cbox_path_64', cornell_box(spp=1, res=64, integrator={
            'type': 'path', 'max_depth': 8}),
         ('bsdfs.params', 'emitters.params'), 1e-6),
        ('hetvol_24', hetvol_box(24, 24, spp=1, grid_res=16, seed=0,
                                 scale=20.0, max_depth=AD_CHECK_DEPTH),
         ('media.params', 'media.grid_sigma_t'), 1e-5))
    for name, desc, keys, atol in cases:
        out, secs = {}, {}
        for device in ('cuda', 'cpu'):
            t0 = time.time()
            scene, meta = mnt.build_scene(desc, device=device)
            pm = ad.traverse(scene).keep(keys)
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in pm.to_dict().items()}
            img = ad.render(scene, meta, params=params, pmap=pm, spp=1,
                            seed=0)
            W = torch.as_tensor(np.random.default_rng(0).standard_normal(
                tuple(img.shape)).astype(np.float32), device=device)
            (img * W).sum().backward()
            out[device] = (img.detach().cpu().numpy(),
                           {k: v.grad.cpu().numpy()
                            for k, v in params.items()})
            secs[device] = time.time() - t0
        img_g, g_g = out['cuda']
        img_c, g_c = out['cpu']
        rec = {'check': name, 'card_s': secs['cuda'], 'cpu_s': secs['cpu'],
               'image_max_abs_err': float(np.abs(img_g - img_c).max())}
        for k in keys:
            err = np.abs(g_g[k] - g_c[k])
            outside = err > atol + 1e-4 * np.abs(g_c[k])
            rec[k] = {'max_abs_err': float(err.max()),
                      'abs_sum': float(np.abs(g_c[k]).sum()),
                      'entries': int(err.size),
                      'outside_tolerance': int(outside.sum()),
                      'outside_err_sum': float(err[outside].sum()),
                      'finite': bool(np.isfinite(g_g[k]).all())}
        emit({'phase': 'autodiff_checks', **rec})
        np.testing.assert_allclose(img_g, img_c, rtol=1e-5, atol=1e-6)
        for k in keys:
            r = rec[k]
            assert r['finite'] and r['abs_sum'] > 0, (k, rec)
            assert r['outside_tolerance'] <= max(1, r['entries'] // 1000), \
                (k, rec)
            assert r['outside_err_sum'] <= 1e-4 * r['abs_sum'], (k, rec)


def run_cli(args, timeout: float):
    """``python -m mitsuba_nlvrl_tpu_torch`` in a subprocess from this
    checkout; (wall s, stdout). Fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    t0 = time.time()
    res = subprocess.run([sys.executable, '-m', 'mitsuba_nlvrl_tpu_torch',
                          *args], cwd=root, env=env, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.time() - t0
    assert res.returncode == 0, (res.returncode, res.stdout[-2000:],
                                 res.stderr[-4000:])
    return wall, res.stdout


def bvh_shape(bvh) -> dict:
    """Node count, depth, leaves and leaf fill of a BVH (numpy arrays)."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.ops.bvh import LEAF_SIZE
    a, b = np.asarray(bvh.node_a), np.asarray(bvh.node_b)
    leaf = np.asarray(bvh.node_leaf)
    depth = np.zeros(len(leaf), np.int64)
    for k in range(len(leaf)):      # preorder: a parent precedes its children
        if not leaf[k]:
            depth[a[k]] = depth[b[k]] = depth[k] + 1
    fill = b[leaf]
    return {'nodes': int(len(leaf)), 'leaves': int(leaf.sum()),
            'depth': int(depth.max()), 'mean_leaf_depth':
            float(depth[leaf].mean()), 'leaf_fill': float(fill.mean()
                                                          / LEAF_SIZE),
            'tris_in_leaves': int(fill.sum())}


def scene_file_phases(torch, mnt, kern, compare, sync, scene, meta, img_np,
                      rays, workdir, bw, fl):
    """The scene-file path on the card: ``scene_file`` (the CLI renders
    cbox_xml, the render phase's scene), ``mesh_build``, ``mesh_render``,
    ``mesh_card_vs_cpu`` and ``bvh_vs_dense`` on cbox_mesh. Returns the
    CLI render's kernel launches and the mesh render's."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import native
    from mitsuba_nlvrl_tpu_torch import sensor as sensor_mod
    from mitsuba_nlvrl_tpu_torch.core import counters, rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions
    from mitsuba_nlvrl_tpu_torch.ops import bvh as bvh_mod
    from mitsuba_nlvrl_tpu_torch.scene.builder import (SceneBuilder,
                                                       scene_from_numpy)
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cbox_light_spd,
                                                        cbox_mesh, cbox_xml,
                                                        cornell_box)
    from mitsuba_nlvrl_tpu_torch.utils.io import read_exr

    def rgb(path):
        im, names = read_exr(path)
        return im[..., [names.index(c) for c in 'RGB']]

    # --- scene_file: cbox_xml through the CLI, 512x512, 16 spp ----------
    path = cbox_xml(os.path.join(workdir, 'cbox'), spp=16, res=512,
                    max_depth=8)
    a_x, m_x = SceneBuilder(load_file(path)).build()
    a_d, m_d = SceneBuilder(cornell_box(
        spp=16, res=512, integrator={'type': 'path', 'max_depth': 8},
        radiance=cbox_light_spd())).build()
    same = m_x == m_d and set(a_x) == set(a_d) and all(
        np.array_equal(np.asarray(a_x[k]), np.asarray(a_d[k])) for k in a_d)
    exr = os.path.join(workdir, 'cbox.exr')
    wall, out = run_cli([path, '-o', exr, '-v'], timeout=300)
    stats = json.loads([x for x in out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    cli_img = rgb(exr)
    # the render phase's scene again, pass by pass, for the z-test
    ref, ref_passes, ref_rays = compare.render_with_passes(scene, meta, 0, 16)
    agree = compare.agreement(cli_img, ref, ref_passes, stats['rays'],
                              ref_rays)
    emit({'phase': 'scene_file', 'scene': 'cbox_xml', 'res': 512, 'spp': 16,
          'max_depth': 8, 'process_wall_s': wall,
          'render_s': stats['render_s'], 'rays': stats['rays'],
          'mrays_per_s': stats['mrays_per_s'],
          'launches': stats['kernel_launches'],
          'host_syncs': stats['host_syncs'], 'bvh_calls': stats['bvh_calls'],
          'arrays_equal_dict_route': same,
          'bit_equal_render_phase': cli_img.tobytes() == img_np.tobytes(),
          'render_phase_rays': rays, **agree})
    assert same, "cbox_xml built other arrays than the dict route"
    assert stats['rays'] == ref_rays == rays, (stats['rays'], ref_rays, rays)
    assert stats['kernel_launches'] == 16 * 8 * 2 and not stats['bvh_calls']
    assert cli_img.shape == (512, 512, 3)
    compare.check(agree)
    cli_launches = stats['kernel_launches']

    # --- mesh_build: cbox_mesh at subdivision 5 ------------------------
    mpath = cbox_mesh(os.path.join(workdir, 'mesh'), subdiv=5, spp=MESH_SPP,
                      res=512, max_depth=8)
    t0 = time.time()
    native.build()          # g++ at first use; the build below is timed
    t_cxx = time.time() - t0
    real_build, built = bvh_mod.build, {}

    def timed_build(*args):
        t = time.time()
        out_ = real_build(*args)
        built['s'], built['bvh'] = time.time() - t, out_
        return out_
    t0 = time.time()
    desc = load_file(mpath)
    t_load = time.time() - t0
    bvh_mod.build = timed_build
    try:
        t0 = time.time()
        arrays, mmeta = SceneBuilder(desc).build()
        t_host = time.time() - t0
    finally:
        bvh_mod.build = real_build
    t0 = time.time()
    mscene, mmeta = scene_from_numpy(arrays, mmeta, 'cuda')
    torch.cuda.synchronize()
    t_up = time.time() - t0
    emit({'phase': 'mesh_build', 'n_tris': mmeta.n_tris,
          'load_s': t_load, 'build_s': t_host, 'bvh_build_s': built['s'],
          'bvh_compile_s': t_cxx,
          'upload_s': t_up, **bvh_shape(built['bvh'])})
    assert mmeta.has_bvh and mmeta.n_tris == 20480 + 12

    # --- mesh_render: 512x512, MESH_SPP, path max_depth 8, through the BVH
    in_trav = {'s': 0.0}
    real_trav = bvh_mod.traverse

    def timed_trav(*args, **kw):
        torch.cuda.synchronize()
        t = time.time()
        res_ = real_trav(*args, **kw)
        torch.cuda.synchronize()
        in_trav['s'] += time.time() - t
        return res_
    mnt.render(mscene, mmeta, seed=0, spp=1)      # warm-up
    torch.cuda.synchronize()
    counters.reset()
    bvh_mod.traverse = timed_trav
    mstats = []
    try:
        t0 = time.time()
        mimg = mnt.render(mscene, mmeta, seed=0, spp=MESH_SPP,
                          ray_stats=mstats)
        torch.cuda.synchronize()
        mwall = time.time() - t0
    finally:
        bvh_mod.traverse = real_trav
    c = counters.read()
    mrays = float(sum(float(r) for r in mstats))
    mimg_np = mimg.cpu().numpy()
    emit({'phase': 'mesh_render', 'res': 512, 'spp': MESH_SPP, 'max_depth': 8,
          'n_tris': mmeta.n_tris, 'wall_s': mwall, 'rays': mrays,
          'mrays_per_s': mrays / mwall / 1e6, 'launches': c['kernel_launches'],
          'host_syncs': c['host_syncs'], 'traverse_calls': c['bvh_calls'],
          'traverse_share': in_trav['s'] / mwall, 'traverse_s': in_trav['s'],
          'steps_per_call_mean': c['bvh_steps'] / max(c['bvh_calls'], 1),
          'steps_per_call_max': c['bvh_max_steps'],
          'lanes_cut': c['bvh_lanes_cut'],
          'finite': bool(np.isfinite(mimg_np).all()),
          'mean': float(mimg_np.mean()), 'shape': list(mimg_np.shape)})
    assert c['bvh_lanes_cut'] == 0, c
    assert c['bvh_calls'] > 0 and np.isfinite(mimg_np).all()
    assert mimg_np.shape == (512, 512, 3) and 0.01 < mimg_np.mean() < 10.0

    # --- mesh_card_vs_cpu: cbox_mesh at 64x64, 2 spp -------------------
    sdesc = load_file(mpath)
    sdesc['sensor']['film'].update(width=64, height=64)
    sdesc['sensor']['sampler']['sample_count'] = 2
    sdesc['integrator']['max_depth'] = CUT_DEPTH
    agree, _ = card_vs_cpu(mnt, compare, sdesc, 2)
    emit({'phase': 'mesh_card_vs_cpu', 'res': 64, 'spp': 2, **agree})
    compare.check(agree)

    # --- bvh_vs_dense: one pass's camera rays, BVH against the kernel --
    pos_key, _ = rng.split(rng.fold_in(rng.PRNGKey(0), 0))
    _, pos01 = film_sample_positions(mmeta, pos_key, 0, torch.device('cuda'))
    cam, _ = sensor_mod.sample_ray(mscene, mmeta, pos01, None)
    g = mscene.geo
    crays = (cam.o.contiguous(), cam.d.contiguous(), cam.mint.contiguous(),
             cam.maxt.contiguous())
    bvh_mod.traverse(mscene.bvh, g.v0, g.e1, g.e2, *crays)   # warm-up
    torch.cuda.synchronize()
    bvh_mod.reset_stats()
    t0 = time.time()
    tb, ib, _, _ = bvh_mod.traverse(mscene.bvh, g.v0, g.e1, g.e2, *crays)
    torch.cuda.synchronize()
    bvh_ms = (time.time() - t0) * 1e3
    kern.launches = 0
    a0, a1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a0.record()
    td, idd, _, _ = kern.intersect_tris(g.v0, g.e1, g.e2, *crays)
    a1.record()
    a1.synchronize()
    dense_ms = a0.elapsed_time(a1)
    assert kern.launches == 1
    hb, hd = torch.isfinite(tb), torch.isfinite(td)
    both = hb & hd
    rel = ((tb - td).abs() / td.abs().clamp(min=1e-30))[both]
    same_t = both & (tb == td)
    _, _, b_bytes, b_ops = bound(crays[0].shape[0], g.v0.shape[0], False,
                                 bw, fl)
    rec = {'phase': 'bvh_vs_dense', 'rays': crays[0].shape[0],
           'tris': g.v0.shape[0], 'hits': int(hb.sum()),
           'hit_or_miss_differ': int((hb != hd).sum()),
           'prim_differ_at_equal_t': int((same_t & (ib != idd)).sum()),
           'prim_differ': int((both & (ib != idd)).sum()),
           'max_rel_t_diff': float(rel.max()) if rel.numel() else 0.0,
           'bvh_ms': bvh_ms, 'dense_kernel_ms': dense_ms,
           'dense_bound_ms': max(b_bytes, b_ops),
           'bvh_steps': bvh_mod.stats['max_steps']}
    emit(rec)
    assert rec['hit_or_miss_differ'] == 0, rec
    return cli_launches, c['kernel_launches']


def kernel_f64_phases(torch, kern, scene, meta, bw, fl64) -> dict:
    """The float64 kernel against its float64 plain version on the double
    scene's camera rays and at its edges (ties, ragged counts, triangles
    across several shared-memory tiles, none), nearest and any hit, equal
    in bits; then its time at 262,144 camera rays x 12 triangles against
    the bound (bytes over the memory rate, FLOPS_PER_PAIR a pair over
    the fp64 rate)."""
    from mitsuba_nlvrl_tpu_torch import sensor as sensor_mod
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions
    dev, f64 = scene.device, torch.float64
    pos_key, _ = rng.split(rng.fold_in(rng.PRNGKey(0), 0))
    _, pos01 = film_sample_positions(meta, pos_key, 0, dev)
    cam, _ = sensor_mod.sample_ray(scene, meta, pos01, None)
    box = (scene.geo.v0, scene.geo.e1, scene.geo.e2)
    cam_rays = tuple(x.contiguous() for x in (cam.o, cam.d, cam.mint,
                                               cam.maxt))
    assert all(x.dtype == f64 for x in box + cam_rays)
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rand(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev,
                                           dtype=f64)

    def random_rays(N):
        o = rand(N, 3, lo=-3.0, hi=3.0)
        d = rand(N, 3) - o
        d = d / d.norm(dim=1, keepdim=True)
        return (o, d.contiguous(), torch.full((N,), 1e-4, device=dev,
                                              dtype=f64),
                torch.full((N,), math.inf, device=dev, dtype=f64))

    def random_tris(T):
        return (rand(T, 3), rand(T, 3, lo=-0.6, hi=0.6),
                rand(T, 3, lo=-0.6, hi=0.6))

    ties = tuple(torch.cat([x, x]).contiguous() for x in random_tris(300))
    cases = {'cbox_camera_512': (box, cam_rays),
             'random_1000': (random_tris(1000), random_rays(65536)),
             'ties_600': (ties, random_rays(65536)),
             'ragged_n': (random_tris(257), random_rays(100003)),
             'zero_tris': (tuple(torch.zeros((0, 3), device=dev, dtype=f64)
                                 for _ in range(3)), random_rays(4099)),
             'n_1': (random_tris(300), random_rays(1))}
    checks, worst = {}, 0.0
    for name, (tris, rays) in cases.items():
        for any_hit in (False, True):
            rec = against_plain(torch, kern, tris, rays, any_hit)
            idx = rec.pop('idx', None)
            worst = max(worst, rec.get('max_abs_err', 0.0))
            if name == 'ties_600' and not any_hit:
                assert bool((idx[idx >= 0] < 300).all()), rec
            if any_hit:   # the float64 kernel writes the smallest hit t
                got = kern.intersect_tris(*tris, *rays, any_hit=True)[0]
                ref = kern.intersect_tris_plain(*tris, *rays,
                                                any_hit=True)[0]
                rec['t_bit_mismatch'] = int((got.view(torch.int64)
                                             != ref.view(torch.int64)).sum())
                assert rec['t_bit_mismatch'] == 0, rec
            checks[f"{name}{'_any' if any_hit else ''}"] = rec
    N, T = cam_rays[0].shape[0], box[0].shape[0]
    ms = time_ms(lambda: kern.intersect_tris(*box, *cam_rays), 7, 50)
    ms_any = time_ms(lambda: kern.intersect_tris(*box, *cam_rays,
                                                 any_hit=True), 7, 50)
    plain_ms = time_ms(lambda: kern.intersect_tris_plain(*box, *cam_rays),
                       5, 3)
    nbytes, nops, b_bytes, b_ops = bound(N, T, False, bw, fl64, 8)
    _, _, b_bytes_any, _ = bound(N, T, True, bw, fl64, 8)
    bound_ms = max(b_bytes, b_ops)
    rec = {'rays': N, 'tris': T, 'ms': ms, 'ms_any_hit': ms_any,
           'plain_ms': plain_ms, 'bytes': nbytes, 'flops': nops,
           'fp64_flops_per_s': fl64, 'bound_ms': bound_ms,
           'bound_bytes_ms': b_bytes, 'bound_ops_ms': b_ops,
           'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
           'roofline_share': bound_ms / ms,
           'roofline_share_any_hit': max(b_bytes_any, b_ops) / ms_any}
    return {'checks': checks, 'max_abs_err': worst, 'time': rec}


def double_render(torch, mnt, kern, sync, scene, meta, spp) -> tuple:
    """``timed_render`` of a float64 scene: both kernels' counts set to 0
    before and read after; (record, image)."""
    kern.launches_f64 = 0
    rec, img = timed_render(torch, mnt, kern, sync, scene, meta, spp)
    rec['launches_f64'] = kern.launches_f64
    return rec, img


def item10_phases(torch, mnt, kern, compare, sync, bw, fl, fl64, workdir,
                  f32_wall) -> dict:
    """Slice 10 on the card. ``measured_render_rays``, ``measured_render``
    and ``measured_cli`` (cbox_measured: the box with an isotropic and an
    anisotropic measured block, read from an XML file and its ``.bsdf``
    files, 512x512, 16 spp, ``path`` max_depth 8; the CLI's EXR equal in
    bits to the in-process render); ``measured_polarized_render_rays`` and
    ``measured_polarized_render`` (a ``.pbsdf`` sphere under ``stokes``
    around ``path``, 512x512, 16 spp, CUT_DEPTH, component 1);
    ``double_kernel`` (the float64 kernel against its plain version and
    timed), ``double_render_rays`` and ``double_render`` (cbox_path in
    float64 beside the float32 render's wall, ``f32_wall``), a float64
    ``cbox_path_grad`` step; then ``item10_checks``, the card against the
    CPU. Returns the renders' launches and the kernels' numbers."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import autodiff as ad
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        cbox_light_spd, cbox_measured, cbox_measured_polarized, cornell_box)
    from mitsuba_nlvrl_tpu_torch.utils.io import read_exr
    out = {'max_abs_err': 0.0}

    def kernel_numbers(tag, own):
        out.update({f'{tag}_ms': own['ms_per_launch'],
                    f'{tag}_plain_ms': own['plain_ms_per_launch'],
                    f'{tag}_bound_ms': own['bound_ms_per_launch'],
                    f'{tag}_bound_by': own['bound_by']})
        out['max_abs_err'] = max(out['max_abs_err'], own['max_abs_err'])

    # --- cbox_measured: a scene file with two .bsdf files --------------
    mdir = os.path.join(workdir, 'measured')
    path = cbox_measured(mdir, spp=16, res=512, max_depth=8)
    t0 = time.time()
    scene, meta = mnt.build_scene(load_file(path))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    assert [tuple(x) for x in meta.measured_meta] == [(True, True, 1),
                                                     (False, True, 2)]
    calls = record_calls(mnt, scene, meta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'measured_render_rays', 'build_s': build_s,
          'n_tris': meta.n_tris, **own})
    del calls
    kernel_numbers('measured', own)
    rec, img_np = timed_render(torch, mnt, kern, sync, scene, meta, 16)
    emit({'phase': 'measured_render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'scene': 'cbox_measured', **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert 0.01 < rec['mean'] < 10.0, rec
    exr = os.path.join(workdir, 'measured.exr')
    wall, cli_out = run_cli([path, '-o', exr, '-v'], timeout=400)
    stats = json.loads([x for x in cli_out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    im, names = read_exr(exr)
    cli_img = im[..., [names.index(c) for c in 'RGB']]
    emit({'phase': 'measured_cli', 'process_wall_s': wall,
          'render_s': stats['render_s'], 'rays': stats['rays'],
          'mrays_per_s': stats['mrays_per_s'],
          'launches': stats['kernel_launches'],
          'host_syncs': stats['host_syncs'],
          'bit_equal_in_process': cli_img.tobytes() == img_np.tobytes()})
    assert cli_img.tobytes() == img_np.tobytes(), \
        "the CLI's measured EXR differs from the in-process render"
    assert stats['rays'] == rec['rays']
    out.update(launches_measured=rec['launches'],
               launches_measured_cli=stats['kernel_launches'])
    del scene

    # --- cbox_measured_polarized: stokes, 512x512, 16 spp --------------
    pscene, pmeta = mnt.build_scene(cbox_measured_polarized(
        os.path.join(workdir, 'pol'), 512, 16, 1, max_depth=CUT_DEPTH))
    calls = record_calls(mnt, pscene, pmeta)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'measured_polarized_render_rays',
          'n_tris': pmeta.n_tris, **own})
    del calls
    kernel_numbers('measured_polarized', own)
    rec, pimg = timed_render(torch, mnt, kern, sync, pscene, pmeta, 16)
    emit({'phase': 'measured_polarized_render', 'res': 512, 'spp': 16,
          'max_depth': CUT_DEPTH, 'component': 1, **rec})
    assert rec['launches'] > 0 and rec['finite'], rec
    assert float(np.abs(pimg).max()) > 1e-3
    out['launches_measured_polarized'] = rec['launches']
    del pscene

    # --- cbox_path in float64 ------------------------------------------
    desc = cornell_box(spp=16, res=512,
                       integrator={'type': 'path', 'max_depth': 8},
                       radiance=cbox_light_spd())
    desc['double'] = True
    dscene, dmeta = mnt.build_scene(desc)
    assert dscene.dtype == torch.float64
    k64 = kernel_f64_phases(torch, kern, dscene, dmeta, bw, fl64)
    emit({'phase': 'double_kernel', **k64})
    out['max_abs_err_f64'] = k64['max_abs_err']
    calls = record_calls(mnt, dscene, dmeta)
    assert [c[2] for c in calls] == [False, True] * 8, len(calls)
    assert all(r.dtype == torch.float64 for _, rays, _ in calls
               for r in rays)
    own64 = render_rays(torch, kern, calls, bw, fl, fl64=fl64)
    emit({'phase': 'double_render_rays', **own64})
    del calls
    out['max_abs_err_f64'] = max(out['max_abs_err_f64'],
                                 own64['max_abs_err'])
    rec, dimg = double_render(torch, mnt, kern, sync, dscene, dmeta, 16)
    emit({'phase': 'double_render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'scene': 'cbox_path_double', **rec, 'float32_wall_s': f32_wall,
          'wall_vs_float32': rec['wall_s'] / f32_wall})
    assert rec['launches_f64'] == 16 * 8 * 2 and rec['launches'] == 0, rec
    assert rec['finite'] and 0.01 < rec['mean'] < 10.0, rec
    # one float64 gradient step of cbox_path_grad
    pm = ad.traverse(dscene).keep(['bsdfs.params'])
    leaf = (pm['bsdfs.params'] * 0.3).detach().requires_grad_(True)
    with torch.no_grad():
        target = ad.render(dscene, dmeta, spp=1, seed=3)
    kern.launches_f64 = kern.launches_f64_recompute = 0
    t0 = time.time()
    img = ad.render(dscene, dmeta, params={'bsdfs.params': leaf}, pmap=pm,
                    spp=1, seed=3)
    loss = ((img - target) ** 2).mean()
    loss.backward()
    torch.cuda.synchronize()
    g = leaf.grad
    grec = {'wall_s': time.time() - t0, 'loss': float(loss.detach()),
            'dtype': str(img.dtype), 'grad_finite': bool(g.isfinite().all()),
            'grad_abs_sum': float(g.abs().sum()),
            'launches_f64': kern.launches_f64,
            'launches_f64_recompute': kern.launches_f64_recompute}
    emit({'phase': 'double_grad_step', 'res': 512, 'spp': 1,
          'max_depth': 8, **grec})
    assert grec['grad_finite'] and grec['grad_abs_sum'] > 0, grec
    assert img.dtype == torch.float64 and grec['launches_f64'] > 0, grec
    out.update(launches_f64=rec['launches_f64'] + grec['launches_f64']
               + grec['launches_f64_recompute'],
               launches_double_render=rec['launches_f64'],
               launches_double_grad=grec['launches_f64'],
               launches_double_grad_recompute=grec[
                   'launches_f64_recompute'],
               f64_ms=own64['ms_per_launch'],
               f64_plain_ms=own64['plain_ms_per_launch'],
               f64_bound_ms=own64['bound_ms_per_launch'],
               f64_bound_by=own64['bound_by'])
    del dscene

    item10_checks(torch, mnt, compare, workdir)
    return out


def item10_checks(torch, mnt, compare, workdir) -> None:
    """Slice 10 on the card against the CPU (``compare.check`` on each):
    cbox_measured at 64x64 from its scene file; cbox_measured_polarized
    at 64x64, components 0 and 1 (S1 gated against S0); cbox_path in
    float64 at 64x64, also to its own gate (DOUBLE_RTOL and the rest),
    which its float32 render misses; the repaired spectral fallback: a spectral
    ``volpath`` render of hetvol_box at 64x32 and a spectral ``vrl``
    render of cbox_nlvrl at 64x32 (the strict gate on the CPU's maps and
    the means within 5% on each device's own)."""
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        cbox_measured, cbox_measured_polarized, cornell_box, hetvol_box)

    def gate(name, desc, spp, scale=None):
        agree, img_c = card_vs_cpu(mnt, compare, desc, spp, scale)
        emit({'phase': 'item10_checks', 'check': name, 'spp': spp, **agree})
        compare.check(agree)
        return img_c

    gate('cbox_measured', load_file(cbox_measured(
        os.path.join(workdir, 'measured64'), spp=2, res=64, max_depth=8)), 2)
    pdir = os.path.join(workdir, 'pol64')
    s0 = gate('cbox_measured_polarized_s0', cbox_measured_polarized(
        pdir, 64, 2, 0, max_depth=CUT_DEPTH), 2)
    gate('cbox_measured_polarized_s1', cbox_measured_polarized(
        pdir, 64, 2, 1, max_depth=CUT_DEPTH), 2, scale=s0)
    desc = cornell_box(spp=4, res=64,
                       integrator={'type': 'path', 'max_depth': 8})
    desc['double'] = True
    agree = double_card_vs_cpu(mnt, compare, desc, 4)
    emit({'phase': 'item10_checks', 'check': 'cbox_path_double', 'spp': 4,
          'rtol': DOUBLE_RTOL, 'pixel_fraction': DOUBLE_PIXEL_FRACTION,
          'mean_rtol': DOUBLE_MEAN_RTOL, **agree})
    compare.check(agree)
    assert agree['dtype'] == agree['cpu_dtype'] == 'float64', agree
    assert agree['pixels_within_rtol'] >= DOUBLE_PIXEL_FRACTION, agree
    assert agree['mean_rel'] <= DOUBLE_MEAN_RTOL, agree
    assert agree['float32_pixels_within_rtol'] < DOUBLE_PIXEL_FRACTION, agree
    assert agree['float32_mean_rel'] > DOUBLE_MEAN_RTOL, agree
    desc = hetvol_box(64, 32, spp=HETVOL_CHECK_SPP, grid_res=32, seed=0,
                      scale=100.0, max_depth=CUT_DEPTH)
    desc['spectral'] = True
    gate('hetvol_volpath_spectral', desc, HETVOL_CHECK_SPP)
    agree, own_maps = nlvrl_card_vs_cpu(
        mnt, compare, nlvrl_check_desc('vrl', spectral=True), 2)
    emit({'phase': 'item10_checks', 'check': 'cbox_nlvrl_vrl_spectral',
          **agree, 'own_maps': own_maps})
    compare.check(agree)
    assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, \
        own_maps



def main() -> int:
    try:
        return _main()
    finally:
        stop_cpu_halves()


def _main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
    from mitsuba_nlvrl_tpu_torch.testing import compare
    from mitsuba_nlvrl_tpu_torch.core import sync
    from mitsuba_nlvrl_tpu_torch.testing.walk_probe import record_walks
    from mitsuba_nlvrl_tpu_torch.integrators import lighttrace
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cbox_light_spd,
                                                        cbox_nlvrl,
                                                        cornell_box,
                                                        hetvol_box)

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({'phase': 'device', 'nvidia_smi': smi, 'name': name,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda})
    dev = torch.device('cuda')

    # --- build ---------------------------------------------------------
    t0 = time.time()
    kern.build(verbose=True)
    emit({'phase': 'build', 'seconds': time.time() - t0,
          'library': kern.library_path()})
    start_cpu_halves(cpu_half_jobs())

    # --- the launch geometry and the kernel against its plain version ---
    emit({'phase': 'geometry_check', **geometry_check(torch, kern)})
    # the Cornell box with the reference cbox.xml's light SPD: the scene
    # that cbox_xml writes, so the scene_file phase renders the same
    desc = cornell_box(spp=16, res=512,
                       integrator={'type': 'path', 'max_depth': 8},
                       radiance=cbox_light_spd())
    scene, meta = mnt.build_scene(desc)
    checks, worst, box, cam_rays = kernel_check(torch, kern, dev, scene,
                                                meta)
    emit({'phase': 'kernel_check', 'cases': checks, 'max_abs_err': worst})
    bw, fl, fl64 = peaks(name)
    # 1,023 random triangles (the largest scene the reference sweeps
    # without a BVH) against 262,144 incoherent rays
    gen = torch.Generator(device=dev).manual_seed(99)

    def rand(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)
    big = (rand(1023, 3, lo=-1.0, hi=1.0), rand(1023, 3, lo=-0.6, hi=0.6),
           rand(1023, 3, lo=-0.6, hi=0.6))
    o = rand(262144, 3, lo=-3.0, hi=3.0)
    d = rand(262144, 3, lo=-1.0, hi=1.0) - o
    big_rays = (o, (d / d.norm(dim=1, keepdim=True)).contiguous(),
                torch.full((262144,), 1e-4, device=dev),
                torch.full((262144,), math.inf, device=dev))
    for shape, tris, rays in (('cbox_camera_512', box, cam_rays),
                              ('random_1023', big, big_rays)):
        rec = kernel_time(torch, kern, tris, rays, bw, fl)
        emit({'phase': 'kernel_time', 'shape': shape,
              'rays': rays[0].shape[0], 'tris': tris[0].shape[0], **rec})

    # --- the render's own rays: one pass, every call (also the warm-up) -
    calls = record_calls(mnt, scene, meta)
    # a pass traces 8 bounces, each a nearest-hit and a shadow-ray call
    assert [c[2] for c in calls] == [False, True] * 8, len(calls)
    own = render_rays(torch, kern, calls, bw, fl)
    emit({'phase': 'render_rays', **own})
    del calls
    worst = max(worst, own['max_abs_err'])

    # --- the main path: 512x512 Cornell box, 16 spp, path max_depth 8 ---
    torch.cuda.synchronize()
    kern.launches = 0
    stats, info = [], {}
    t0 = time.time()
    img = mnt.render(scene, meta, seed=0, spp=16, ray_stats=stats,
                     info=info)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kern.launches
    rays = float(sum(float(r) for r in stats))
    img_np = img.cpu().numpy()
    finite = bool(img.isfinite().all())
    emit({'phase': 'render', 'res': 512, 'spp': 16, 'max_depth': 8,
          'wall_s': wall, 'rays': rays, 'mrays_per_s': rays / wall / 1e6,
          'launches': launches,
          'kernel_share_est': launches * own['ms_per_launch'] / 1e3 / wall,
          'finite': finite, 'mean': float(img_np.mean()),
          'shape': list(img_np.shape)})
    # 16 passes x 8 bounces x (nearest hit + shadow rays): no pass of the
    # Cornell box ends early at 262,144 lanes
    assert launches == 16 * 8 * 2, launches
    assert finite and img_np.shape == (512, 512, 3), img_np.shape
    assert 0.01 < float(img_np.mean()) < 10.0, img_np.mean()

    # --- the card path against the CPU path, 64x64 at 4 spp -----------
    agree, _ = card_vs_cpu(mnt, compare, cornell_box(
        spp=4, res=64, integrator={'type': 'path', 'max_depth': 8}), 4)
    emit({'phase': 'card_vs_cpu', **agree})
    compare.check(agree)

    # --- the scene-file path: the CLI on cbox_xml, then the mesh scene --
    workdir = tempfile.mkdtemp(prefix='chip_smoke_scenes_')
    try:
        cli_launches, mesh_launches = scene_file_phases(
            torch, mnt, kern, compare, sync, scene, meta, img_np, rays,
            workdir, bw, fl)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # --- the volumetric slice: hetvol_box at full width ----------------
    t0 = time.time()
    vdesc = hetvol_box(768, 576, spp=2, grid_res=128, seed=0, scale=100.0)
    vscene, vmeta = mnt.build_scene(vdesc)
    emit({'phase': 'vol_build', 'seconds': time.time() - t0,
          'n_tris': vmeta.n_tris,
          'occluder_tris': vscene.occluders.v0.shape[0],
          'grid': list(vscene.media.grid_sigma_t.shape),
          'packed_rows': list(vscene.media.grid_sigma_p8.shape)})
    # one pass's calls (also the warm-up): nearest hit on the scene's 24
    # triangles, any hit on its 12 occluders
    vcalls = record_calls(mnt, vscene, vmeta)
    assert {(c[0][0].shape[0], c[2]) for c in vcalls} == {(24, False),
                                                         (12, True)}
    vown = render_rays(torch, kern, vcalls, bw, fl)
    emit({'phase': 'vol_render_rays', **vown})
    del vcalls
    worst = max(worst, vown['max_abs_err'])

    torch.cuda.synchronize()
    kern.launches = 0
    sync.host_syncs = 0
    vstats, t0 = [], time.time()
    with record_walks(timed=True) as wlog:
        vimg = mnt.render(vscene, vmeta, seed=0, spp=2, ray_stats=vstats)
        torch.cuda.synchronize()
    vwall = time.time() - t0
    vlaunches, vsyncs = kern.launches, sync.host_syncs
    vrays = float(sum(float(r) for r in vstats))
    walk_s = wlog.device_s()
    walk_rec = {'walks': len(wlog.walks), 'trips': wlog.trips(),
                'host_s': wlog.host_s()}
    vimg_np = vimg.cpu().numpy()
    vfinite = bool(vimg.isfinite().all())
    emit({'phase': 'vol_render', 'res': [768, 576], 'spp': 2,
          'grid_res': 128, 'sigma_t_scale': 100.0, 'max_depth': 8,
          'wall_s': vwall, 'rays': vrays, 'mrays_per_s': vrays / vwall / 1e6,
          'launches': vlaunches, 'host_syncs': vsyncs,
          'walk_share': walk_s / vwall,
          'walk_share_host': walk_rec['host_s'] / vwall,
          'walk_s': walk_s, **walk_rec,
          'kernel_share_est': vlaunches * vown['ms_per_launch'] / 1e3 / vwall,
          'finite': vfinite, 'mean': float(vimg_np.mean()),
          'shape': list(vimg_np.shape)})
    assert vlaunches > 0 and walk_rec['walks'] > 0, (vlaunches, walk_rec)
    assert vfinite and vimg_np.shape == (576, 768, 3), vimg_np.shape
    assert 0.01 < float(vimg_np.mean()) < 10.0, vimg_np.mean()

    # --- the volumetric card path against the CPU path, 64x64 ----------
    for scene_name, desc, spp in (
            ('hetvol_volpath', hetvol_box(64, 64, spp=HETVOL_CHECK_SPP,
                                          grid_res=32, seed=0, scale=100.0,
                                          max_depth=CUT_DEPTH),
             HETVOL_CHECK_SPP),
            ('homogeneous_volpathmis', cornell_box(
                spp=4, res=64,
                integrator={'type': 'volpathmis', 'max_depth': CUT_DEPTH},
                medium={'type': 'homogeneous', 'sigma_t': 0.5,
                        'albedo': 0.8}), 4)):
        agree, _ = card_vs_cpu(mnt, compare, desc, spp)
        emit({'phase': 'vol_card_vs_cpu', 'scene': scene_name, 'spp': spp,
              **agree})
        compare.check(agree)

    # --- the NLVRL slice: cbox_nlvrl at full width ---------------------
    t0 = time.time()
    nscene, nmeta = mnt.build_scene(cbox_nlvrl(512, 256, spp=2,
                                               target_vrls=8000))
    emit({'phase': 'nlvrl_build', 'seconds': time.time() - t0,
          'n_tris': nmeta.n_tris,
          'occluder_tris': nscene.occluders.v0.shape[0],
          'ior_cells': nscene.media.nl_ior.shape[0],
          'integrator': nmeta.integrator})
    assert nscene.media.nl_ior.shape[0] == 640, nscene.media.nl_ior.shape

    torch.cuda.synchronize()
    kern.launches = 0
    sync.host_syncs = 0
    t0 = time.time()
    nmaps = mnt.preprocess(nscene, nmeta, 0)
    torch.cuda.synchronize()
    pre_s = time.time() - t0
    pre_launches, pre_syncs = kern.launches, sync.host_syncs
    mstats = lighttrace.map_stats(nmaps)
    cl = nmaps.clusters
    emit({'phase': 'nlvrl_preprocess', 'wall_s': pre_s,
          'launches': pre_launches, 'host_syncs': pre_syncs, **mstats,
          'clusters': {'K1': cl.c_lum.shape[0], 'K2': cl.s_lum.shape[1],
                       'M': cl.rows.shape[1] // 5}})
    assert pre_launches > 0 and mstats['vrl_count'] > 0, mstats
    assert mstats['surface_photons'] > 0 and mstats['volume_photons'] > 0

    # one render's calls (also the warm-up): the light pass's nearest and
    # any hits on 8,192 rays, the camera pass's on 131,072
    ncalls = record_calls(mnt, nscene, nmeta)
    nstride = max(1, len(ncalls) // 64)
    nown = render_rays(torch, kern, ncalls, bw, fl, stride=nstride)
    nown['ray_counts'] = sorted({c[1][0].shape[0] for c in ncalls})
    emit({'phase': 'nlvrl_render_rays', **nown})
    del ncalls
    worst = max(worst, nown['max_abs_err'])

    nrec, nimg_np = two_pass_render(torch, mnt, sync, kern, nscene, nmeta, 2)
    nlaunches = nrec['launches']
    emit({'phase': 'nlvrl_render', 'res': [512, 256], 'spp': 2,
          'integrator': 'vrl', 'target_vrls': 8000, **nrec,
          'kernel_share_est': nlaunches * nown['ms_per_launch'] / 1e3
          / nrec['wall_s']})
    assert nlaunches > 0 and nrec['parts']['bend']['calls'] > 0, nlaunches
    assert nrec['parts']['vrl_query']['calls'] > 0
    assert nrec['parts']['volume_gather']['calls'] > 0
    assert nrec['finite'] and nimg_np.shape == (256, 512, 3), nimg_np.shape
    assert 0.0 < nrec['mean'] < 10.0, nrec['mean']

    # --- the NLVRL card path against the CPU path, 64x32 at 2 spp -------
    for integ in ('vrl', 'photonmapper'):
        agree, own_maps = nlvrl_card_vs_cpu(mnt, compare,
                                            nlvrl_check_desc(integ), 2)
        emit({'phase': 'nlvrl_card_vs_cpu', 'integrator': integ, **agree,
              'own_maps': own_maps})
        compare.check(agree)
        assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, \
            own_maps

    # --- slice 6: the microfacet and plastic BSDFs, the thesis options --
    mat = materials_phases(torch, mnt, kern, compare, sync, bw, fl)
    opt = nlvrl_option_phases(torch, mnt, kern, compare, sync, bw, fl)
    # --- slice 7: textures, wrappers, lights, samplers, sensors ---------
    workdir = tempfile.mkdtemp(prefix='chip_smoke_item7_')
    try:
        it7 = item7_phases(torch, mnt, kern, compare, sync, bw, fl, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # --- slice 8: spectral, polarized, wrappers, regeneration ----------
    workdir = tempfile.mkdtemp(prefix='chip_smoke_item8_')
    ior_dir = os.environ.get('MNT_IOR_DIR')
    try:
        it8 = item8_phases(torch, mnt, kern, compare, sync, bw, fl, workdir,
                           {'wall_s': vwall, 'rays': vrays,
                            'launches': vlaunches, 'host_syncs': vsyncs})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if ior_dir is None:
            os.environ.pop('MNT_IOR_DIR', None)
        else:
            os.environ['MNT_IOR_DIR'] = ior_dir
    # --- slice 9: differentiable rendering -----------------------------
    pgrad = path_grad_phase(torch, mnt, kern, sync)
    hgrad = hetvol_grad_phase(torch, mnt, kern, sync)
    autodiff_checks(torch, mnt)
    # --- slice 10: measured BSDFs, float64, the spectral fallback -------
    workdir = tempfile.mkdtemp(prefix='chip_smoke_item10_')
    try:
        it10 = item10_phases(torch, mnt, kern, compare, sync, bw, fl, fl64,
                             workdir, wall)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    left = stop_cpu_halves()
    assert not left, f"{len(left)} CPU halves submitted and not taken"
    ad_launches = (pgrad['launches'] + pgrad['launches_recompute']
                   + hgrad['launches'] + hgrad['launches_recompute'])
    worst = max(worst, mat['max_abs_err'],
                opt['nlvrl_aniso_rays']['max_abs_err'],
                opt['long_vrl']['max_abs_err'], it7['max_abs_err'],
                it8['max_abs_err'], it10['max_abs_err'])
    new_launches = (mat['launches_materials'] + mat['launches_materials_pm']
                    + opt['launches_nlvrl_aniso']
                    + opt['launches_nlvrl_ris_bre']
                    + it7['launches_textured'] + it7['launches_textured_cli']
                    + it7['launches_env'] + it8['launches_spectral']
                    + it8['launches_spectral_cli']
                    + it8['launches_polarized']
                    + it8['launches_spectral_polarized']
                    + it8['launches_regen'] + ad_launches
                    + it10['launches_measured']
                    + it10['launches_measured_cli']
                    + it10['launches_measured_polarized'])

    emit({'kernels': [{
        'name': 'intersect_tris', 'route': 'cuda',
        'source': 'mitsuba_nlvrl_tpu_torch/csrc/intersect.cu',
        'replaces': 'mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py:26',
        'launches': (launches + vlaunches + nlaunches + cli_launches
                     + new_launches),
        'max_abs_err': worst,
        'ms': own['ms_per_launch'], 'plain_ms': own['plain_ms_per_launch'],
        'bound_ms': own['bound_ms_per_launch'], 'bound_by': own['bound_by'],
        'library_ms': None,
        'launches_surface': launches, 'launches_volume': vlaunches,
        'volume_ms': vown['ms_per_launch'],
        'volume_plain_ms': vown['plain_ms_per_launch'],
        'volume_bound_ms': vown['bound_ms_per_launch'],
        'volume_bound_by': vown['bound_by'],
        'launches_nlvrl': nlaunches, 'nlvrl_ms': nown['ms_per_launch'],
        'nlvrl_plain_ms': nown['plain_ms_per_launch'],
        'nlvrl_bound_ms': nown['bound_ms_per_launch'],
        'nlvrl_bound_by': nown['bound_by'],
        'launches_scene_file': cli_launches,
        'launches_mesh_render': mesh_launches,
        'launches_materials': mat['launches_materials'],
        'materials_ms': mat['materials_ms'],
        'materials_plain_ms': mat['materials_plain_ms'],
        'materials_bound_ms': mat['materials_bound_ms'],
        'launches_materials_pm': mat['launches_materials_pm'],
        'launches_nlvrl_aniso': opt['launches_nlvrl_aniso'],
        'nlvrl_aniso_ms': opt['nlvrl_aniso_rays']['ms_per_launch'],
        'nlvrl_aniso_plain_ms': opt['nlvrl_aniso_rays']['plain_ms_per_launch'],
        'nlvrl_aniso_bound_ms': opt['nlvrl_aniso_rays']['bound_ms_per_launch'],
        'launches_nlvrl_ris_bre': opt['launches_nlvrl_ris_bre'],
        'long_vrl_rays': opt['long_vrl']['rays'],
        'long_vrl_ms': opt['long_vrl']['ms'],
        'long_vrl_plain_ms': opt['long_vrl']['plain_ms'],
        'long_vrl_bound_ms': opt['long_vrl']['bound_ms'],
        'long_vrl_bound_by': opt['long_vrl']['bound_by'],
        'launches_textured': it7['launches_textured'],
        'launches_textured_cli': it7['launches_textured_cli'],
        'textured_ms': it7['textured_ms'],
        'textured_plain_ms': it7['textured_plain_ms'],
        'textured_bound_ms': it7['textured_bound_ms'],
        'launches_env': it7['launches_env'], 'env_ms': it7['env_ms'],
        'env_plain_ms': it7['env_plain_ms'],
        'env_bound_ms': it7['env_bound_ms'],
        **{k: v for k, v in it8.items() if k != 'max_abs_err'},
        'launches_autodiff': ad_launches,
        'launches_cbox_path_grad': pgrad['launches'],
        'launches_cbox_path_grad_recompute': pgrad['launches_recompute'],
        'launches_hetvol_volpath_grad': hgrad['launches'],
        'launches_hetvol_volpath_grad_recompute':
            hgrad['launches_recompute'],
        **{k: it10[k] for k in (
            'launches_measured', 'launches_measured_cli', 'measured_ms',
            'measured_plain_ms', 'measured_bound_ms', 'measured_bound_by',
            'launches_measured_polarized', 'measured_polarized_ms',
            'measured_polarized_plain_ms', 'measured_polarized_bound_ms',
            'measured_polarized_bound_by')}}, {
        'name': 'intersect_tris_f64', 'route': 'cuda',
        'source': 'mitsuba_nlvrl_tpu_torch/csrc/intersect_f64.cu',
        'replaces': 'mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py:26',
        'launches': it10['launches_f64'],
        'max_abs_err': it10['max_abs_err_f64'],
        'ms': it10['f64_ms'], 'plain_ms': it10['f64_plain_ms'],
        'bound_ms': it10['f64_bound_ms'], 'bound_by': it10['f64_bound_by'],
        'library_ms': None,
        'launches_double_render': it10['launches_double_render'],
        'launches_double_grad': it10['launches_double_grad'],
        'launches_double_grad_recompute':
            it10['launches_double_grad_recompute']}]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())

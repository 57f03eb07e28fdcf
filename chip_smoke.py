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
Then slice 11: the redesigned float64 kernel is held in bits on more
edges (the whole-set cap of 512 triangles and the ring above it, grids
one tile short of or over the resident blocks, misaligned rays, bounded
t, extreme scales) and timed at 262,144 random rays x 1,023 random
triangles too; every float64 call of the float64 gradient step, its
recompute's too, is held in bits as it is made; ``autodiff_checks``
adds the materials box at 64x64 (every microfacet and plastic BSDF: the
gradient of bsdfs.params finite on both devices and within the CPU
tests' tolerance); and ``integrator_keyword`` renders a ``path`` box
with ``integrator='depth'`` on the card.
Then slice 12, the sharded paths through NCCL at world size 1 (a file
store in a temporary directory; the process group is left in the
script's ``finally``): ``render_distributed`` on the 512x512 Cornell box
(every kernel call of one dispatch bit for bit and timed; the 16 spp
render with its launches, all-reduces and their device time beside
``render``'s wall; a 64x64 render against the CPU's), ``measure_fold``
on a 256x128 film at 8 folds, ``dp_fold_proxy``, the weak-scaling sweep
that sets ``render_dist.SATURATION_LANES`` and ``measure_scaling``, each
rate under its plausibility bound, one ``cbox_nlvrl`` camera pass
through ``make_sharded_vrl_render`` on a 1x1 mesh (every kernel call bit
for bit, the radiance equal in bits to the unsharded pass's) and
``train_step`` on the card against the CPU.
Then slices 13 and 14, the bitmap formats: ``bitmap_decode`` decodes
every fixture of ``tests/data/bitmaps`` (JPEG sequential, progressive,
CMYK and YCCK; BMP, TGA, PNM, GIF, TIFF and WebP layouts: lossless,
lossy, with ALPH, an animation's first frame) with the port's decoders,
which use no PIL, each equal to PIL's stored bytes, and
the 512x512 lossless and lossy WebP files of ``tests/data/webp_large`` to
the digests of PIL's bytes, with host milliseconds per megapixel; and
``textured_formats`` renders ``cbox_textured`` at 64x64, 1 spp on the
card with one 64x64 picture as every bitmap, once in each of seven
lossless formats, each render equal in bits to the PNG copy's.
Slice 15 (the decoders' sequential stages in host C++, built with g++ at
first use): ``bitmap_decode`` also decodes every file of
``tests/data/bitmaps_large`` (JPEG and WebP at 2,048^2 and 4,096^2) to
PIL's digests and a 4,096^2 PNG it writes with every row Paeth-filtered
to its pixels, each 4,096^2 decode under 3 s of host time; and
``textured_large`` builds ``cbox_textured`` with the 2,048^2 baseline
JPEG as every bitmap and with its pixels as a Paeth PNG (build and
decode seconds), the two renders on the card equal in bits and rays.
Slice 16 (JPEG-in-TIFF and YCbCr TIFF; TIFF's and GIF's LZW, WebP's alpha
gradient and lossless JPEG in host C++; the RNG's counters past 2^32):
``bitmap_decode`` also holds the new TIFF layouts to PIL's bytes and the
2,048^2 LZW TIFF, GIF and JPEG-in-TIFF to PIL's digests, the LZW TIFF and
the GIF each under 1 s of host time; ``textured_large`` renders the JPEG's
pixels a third time, as an LZW TIFF written here, equal in bits and rays
to the JPEG's render; and ``rng_wide`` draws at lanes of a wavefront past
2^32 elements on the card, equal in bits to the CPU's draw, in float32
and float64.
Slice 17 (the rest of TIFF: CCITT, old-style JPEG, CIELab, 12-bit grey,
every orientation, the last YCbCr layouts; DDS, QOI, SGI and PCX):
``bitmap_decode`` also holds their fixtures to PIL's bytes and a 2,048^2
G4 TIFF and two 2,048^2 DDS files of seeded random BC1 and BC7 blocks
(written here) to PIL's digests, with host milliseconds per megapixel;
``textured_formats`` adds QOI, SGI, PCX and uncompressed DDS copies of the
picture.
Slice 18 (JPEG 2000, JP2 and raw codestreams, tier 1 and the inverse
wavelets in host C++; ICO, CUR and ICNS): ``bitmap_decode`` also holds
their fixtures to PIL's bytes, and a 2,048^2 irreversible and a 2,048^2
reversible JP2 and PIL's 1,024^2 ICNS to PIL's digests, the irreversible
JP2 under 2 s of host time; ``textured_formats`` adds the reversible JP2
and the ICO (a PNG icon) copies of the picture (thirteen renders).
Slice 19 (the rest of TIFF: a Zstandard decoder in host C++, LZMA,
word-aligned CCITT RLE, ThunderScan, JPEG in planes and CMYK, tiled
YCbCr; PSD): ``bitmap_decode`` also holds their fixtures to PIL's bytes,
the files PIL refuses (SGILog, WebP TIFF, PSD depths) to PIL's exception
class, and a 2,048^2 Zstandard TIFF to PIL's digest under 1 s of host
time, and reports whether ``lzma`` imported; ``textured_formats`` adds
the PSD and the Zstandard TIFF copies of the picture (fifteen renders).
Slice 20 (the rest of PIL's raster formats: SUN, BLP, FTEX, FITS, SPIDER,
IM, IMT, MSP, FLI/FLC, XBM, XPM, GBR, McIDAS, PIXAR, XV thumbnails, PCD,
DCX, IPTC; Sun's and MSP's RLE and FLI's chunks in host C++; the six
formats PIL opens and cannot load refused as PIL refuses them):
``bitmap_decode`` also holds their fixtures to PIL's bytes and their
refused files to PIL's class, and a seeded 2,048^2 RLE Sun raster, a
seeded 2,048^2 FLC of BRUN, LC and SS2 chunks and a seeded Photo CD file
(written here) to PIL's digests, the Sun raster and the FLC each under
1 s of host time; ``textured_formats`` adds a 24-bit RLE Sun raster and an
RGB IM copy of the picture (seventeen renders).
The CPU halves of every check against the CPU run in two spawned worker
processes beside the card's phases (their scene files written before
they start), the CLI renders in subprocesses beside the phases after each
slice's last timed kernel calls, and the regeneration check's card
renders in a spawned process of their own; the script ends them all on
every exit. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero. Without a CUDA device it
exits non-zero at once and prints no result. It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import contextlib
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


def record_calls(mnt, scene, meta, mark=None, run=None) -> list:
    """One pass (spp 1) of a render, or ``run()`` where it is given,
    keeping a copy of the triangles and rays of every intersection call
    it makes: [(tris, rays, any_hit)] in the order of the calls. ``mark``
    (module, function name, list): the indices of the calls made inside
    that function go to the list."""
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
        if run is None:
            mnt.render(scene, meta, seed=0, spp=1)
        else:
            run()
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


def card_vs_cpu(mnt, compare, desc, spp, scale=None, half=None,
                env=()) -> tuple:
    """One scene rendered on the card and on the CPU from one seed: (the
    numbers of ``compare.agreement``, gated against ``scale`` where it is
    given, the CPU's image). The CPU's render comes from a worker where
    it was submitted (``start_cpu_halves``, under ``env``); ``half``,
    where given, gets whether it did and the seconds spent waiting for
    it."""
    take = claim_cpu_half(cpu_render_half, desc, spp, env)
    sg, mg = mnt.build_scene(desc)
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp)
    (img_c, passes_c, rays_c), info = take()
    if half is not None:
        half.update(info)
    return compare.agreement(img_g, img_c, passes_c, rays_g, rays_c,
                             scale=scale), img_c


def double_card_vs_cpu(mnt, compare, desc, spp) -> dict:
    """A float64 scene on the card and on the CPU from one seed: the
    numbers of ``compare.agreement``, the images' dtypes, the share of
    pixels within DOUBLE_RTOL and the largest relative pixel error; and
    the same two and the means' relative difference for the card's
    float32 render of the same scene against the CPU's float64 one."""
    import numpy as np
    take = claim_cpu_half(cpu_render_half, desc, spp)
    sg, mg = mnt.build_scene(desc)
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp)
    s32, m32 = mnt.build_scene({**desc, 'double': False})
    img_32, _, _ = compare.render_with_passes(s32, m32, 0, spp)

    def pixel_rel(img):
        rel = np.abs(img.astype(np.float64) - img_c) / (np.abs(img_c)
                                                        + 1e-12)
        return rel.max(axis=-1)

    (img_c, passes_c, rays_c), half = take()
    rel_g, rel_32 = pixel_rel(img_g), pixel_rel(img_32)
    return {**compare.agreement(img_g, img_c, passes_c, rays_g, rays_c),
            **half,
            'dtype': str(img_g.dtype), 'cpu_dtype': str(img_c.dtype),
            'pixels_within_rtol': float((rel_g <= DOUBLE_RTOL).mean()),
            'max_pixel_rel': float(rel_g.max()),
            'float32_pixels_within_rtol': float(
                (rel_32 <= DOUBLE_RTOL).mean()),
            'float32_max_pixel_rel': float(rel_32.max()),
            'float32_mean_rel': float(abs(img_32.mean() - img_c.mean())
                                      / abs(img_c.mean()))}


# The CPU halves of the checks against the CPU (every render, light pass
# and gradient that a check computes on the CPU, 12-46 s for the largest,
# PERF.md §4) run in spawned worker processes beside the card's phases:
# ``start_cpu_halves`` submits them, ``claim_cpu_half`` takes one from
# there by the pickled (function, description, spp, environment), and
# computes one in process that was not submitted. ``stop_cpu_halves`` ends
# the workers. Scenes that read files (scene files, meshes, bitmaps,
# measured BSDFs, conductor curves) are written into one directory before
# the workers start (``prepare_check_files``), and the phases check those
# same descriptions.
_cpu_pool = None
_cpu_jobs = {}
_PREP = {}
CPU_WORKERS = 2


def cpu_worker_threads() -> int:
    """Torch threads a worker: the host's cores but one (the main
    process's) shared between the workers, oversubscribing none."""
    return max(1, ((os.cpu_count() or 2) - 1) // CPU_WORKERS)


def _cpu_worker_init(threads: int) -> None:
    """A worker's torch threads, and a lower priority than the main
    process's host work, which paces the card."""
    import torch
    os.nice(10)
    torch.set_num_threads(threads)


@contextlib.contextmanager
def environ(env):
    """The variables ``env`` ((name, value) pairs) set in the environment
    for the block, then restored."""
    saved = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _in_env(fn, desc, spp, env) -> tuple:
    """``fn(desc, spp)`` under ``environ(env)``."""
    with environ(env):
        return fn(desc, spp)


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


def cpu_render_half(desc, spp) -> tuple:
    """The CPU's half of ``card_vs_cpu``: (the image, the per-pass images,
    the rays)."""
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.testing import compare
    sc, mc = mnt.build_scene(desc, device='cpu')
    return compare.render_with_passes(sc, mc, 0, spp)


def _job_key(fn, desc, spp, env) -> bytes:
    return pickle.dumps((fn.__name__, desc, spp, tuple(env)))


def start_cpu_halves(jobs) -> None:
    """Submit ``jobs`` ((function, description, spp[, environment]), in
    the order the phases reach them) to ``CPU_WORKERS`` spawned worker
    processes of ``cpu_worker_threads`` torch threads each."""
    global _cpu_pool
    import multiprocessing
    _cpu_pool = multiprocessing.get_context('spawn').Pool(
        CPU_WORKERS, initializer=_cpu_worker_init,
        initargs=(cpu_worker_threads(),))
    for fn, desc, spp, *env in jobs:
        env = tuple(env[0]) if env else ()
        _cpu_jobs[_job_key(fn, desc, spp, env)] = _cpu_pool.apply_async(
            _in_env, (fn, desc, spp, env))


def claim_cpu_half(fn, desc, spp, env=()):
    """Claim ``fn(desc, spp)`` (under ``env``) before the card's half
    runs: returns a function that gives (the result, taken from the
    worker where it was submitted and computed here otherwise, and
    {'cpu_half_in_worker': whether it was submitted, 'cpu_half_wait_s':
    the seconds spent here for it})."""
    job = _cpu_jobs.pop(_job_key(fn, desc, spp, env), None)

    def take():
        t0 = time.time()
        out = _in_env(fn, desc, spp, env) if job is None else job.get()
        return out, {'cpu_half_in_worker': job is not None,
                     'cpu_half_wait_s': time.time() - t0}
    return take


def take_cpu_half(fn, desc, spp, env=()) -> tuple:
    """``claim_cpu_half(...)()``: the result and where it came from."""
    return claim_cpu_half(fn, desc, spp, env)()


# Card checks that need nothing of the phases before them run in one
# spawned process of their own beside the phases (started once the phases
# that time the kernel, which they would share the card with, are past):
# ``start_card_job`` submits one by name, ``take_card_job`` waits for it.
_card_pool = None
_card_jobs = {}


def _card_job(name: str):
    return globals()[name]()


def start_card_job(name: str) -> None:
    global _card_pool
    import concurrent.futures
    import multiprocessing
    if _card_pool is None:
        _card_pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context('spawn'))
    _card_jobs[name] = (_card_pool.submit(_card_job, name), time.time())


def take_card_job(name: str) -> tuple:
    """(the job's result, {'card_job_s': seconds since it was submitted,
    'card_job_wait_s': the seconds spent here for it})."""
    future, t_submit = _card_jobs.pop(name)
    t0 = time.time()
    out = future.result()
    return out, {'card_job_s': time.time() - t_submit,
                 'card_job_wait_s': time.time() - t0}


def stop_card_jobs() -> None:
    global _card_pool
    if _card_pool is not None:
        for proc in list(getattr(_card_pool, '_processes', {}).values()):
            proc.terminate()
        _card_pool.shutdown(wait=False, cancel_futures=True)
        _card_pool = None
    _card_jobs.clear()


def stop_cpu_halves() -> list:
    """End the workers; returns the submitted halves no check took."""
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
    (maps_np, cpu_maps, img_c, passes_c, rays_c), half = take_cpu_half(
        nlvrl_cpu_half, desc, spp)
    sg, mg = mnt.build_scene(desc)
    maps_g = mnt.preprocess(sg, mg, 0)
    carried = mnt.maps_from_numpy(maps_np, device='cuda')
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, spp, carried)
    own_g, _, _ = compare.render_with_passes(sg, mg, 0, spp, maps_g)
    own = {'card_maps': lighttrace.map_stats(maps_g),
           'cpu_maps': cpu_maps,
           'card_mean': float(own_g.mean()), 'cpu_mean': float(img_c.mean()),
           'card_finite': bool(np.isfinite(own_g).all()), **half}
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


def vol_check_cases() -> list:
    """The volumetric checks against the CPU: (name, description, spp) of
    the heterogeneous and the homogeneous box at 64x64."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cornell_box,
                                                        hetvol_box)
    return [('hetvol_volpath', hetvol_box(64, 64, spp=HETVOL_CHECK_SPP,
                                          grid_res=32, seed=0, scale=100.0,
                                          max_depth=CUT_DEPTH),
             HETVOL_CHECK_SPP),
            ('homogeneous_volpathmis', cornell_box(
                spp=4, res=64,
                integrator={'type': 'volpathmis', 'max_depth': CUT_DEPTH},
                medium={'type': 'homogeneous', 'sigma_t': 0.5,
                        'albedo': 0.8}), 4)]


def materials_check_desc() -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_materials
    return cbox_materials(64, 64, 4)


def albedo_grid_desc() -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (albedo_grid_medium,
                                                        cornell_box)
    return cornell_box(spp=2, res=64,
                       medium=albedo_grid_medium(16, scale=5.0),
                       integrator={'type': 'volpath', 'max_depth': CUT_DEPTH})


def hetvol_spectral_desc() -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box
    desc = hetvol_box(64, 32, spp=HETVOL_CHECK_SPP, grid_res=32, seed=0,
                      scale=100.0, max_depth=CUT_DEPTH)
    desc['spectral'] = True
    return desc


def cbox_check_desc() -> dict:
    """The 64x64 Cornell box of ``card_vs_cpu`` (4 spp, ``path``)."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    return cornell_box(spp=4, res=64,
                       integrator={'type': 'path', 'max_depth': 8})


def meter_desc(kind) -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    d = cornell_box(spp=64, res=1)
    d['sensor'] = dict(d['sensor'], type=kind)
    return d


def prepare_check_files(prep: str) -> None:
    """Write the files of the checks against the CPU that read files into
    ``prep`` and keep their descriptions in ``_PREP``: ``cbox_mesh`` cut
    to 64x64, 2 spp, ``CUT_DEPTH``; ``cbox_textured`` and ``env_spheres``
    at 64x64, 4 spp; ``cbox_spectral`` at 64x64, 4 spp (its conductor's
    curves, which the polarized checks read too, in ``ior_dir``);
    ``cbox_measured`` at 64x64, 2 spp, and ``cbox_measured_polarized``'s
    components 0 and 1."""
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        cbox_measured, cbox_measured_polarized, cbox_mesh, cbox_spectral,
        cbox_textured, env_spheres)
    mesh = load_file(cbox_mesh(os.path.join(prep, 'mesh'), subdiv=5,
                               spp=MESH_SPP, res=512, max_depth=8))
    mesh['sensor']['film'].update(width=64, height=64)
    mesh['sensor']['sampler']['sample_count'] = 2
    mesh['integrator']['max_depth'] = CUT_DEPTH
    sdir = os.path.join(prep, 'spectral64')
    spectral = load_file(cbox_spectral(sdir, spp=4, res=64, max_depth=8))
    spectral['spectral'] = True
    pdir = os.path.join(prep, 'pol64')
    _PREP.update(
        mesh64=mesh, spectral64=spectral, ior_dir=sdir,
        textured64=load_file(cbox_textured(
            os.path.join(prep, 'textured64'), spp=4, res=64)),
        env64=env_spheres(os.path.join(prep, 'env64'), 64, 64, 4),
        measured64=load_file(cbox_measured(
            os.path.join(prep, 'measured64'), spp=2, res=64, max_depth=8)),
        **{f'measured_pol64_s{c}': cbox_measured_polarized(
            pdir, 64, 2, c, max_depth=CUT_DEPTH) for c in (0, 1)})


def ior_env() -> tuple:
    """The environment of the checks that read the named conductor."""
    return (('MNT_IOR_DIR', _PREP['ior_dir']),)


REGEN_ENV = (('MNT_REGEN', '1'),)


def item7_check_cases() -> tuple:
    """``item7_checks``' renders against the CPU: (name, description,
    spp)."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    return (
        ('cbox_textured', _PREP['textured64'], 4),
        ('env_spheres', _PREP['env64'], 4),
        ('direct', cornell_box(spp=4, res=64,
                               integrator={'type': 'direct'}), 4),
        ('depth', cornell_box(spp=2, res=64,
                              integrator={'type': 'depth'}), 2),
        ('radiancemeter', meter_desc('radiancemeter'), 64),
        ('irradiancemeter', meter_desc('irradiancemeter'), 64))


def spot_directional_desc() -> dict:
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_spot_directional
    return cbox_spot_directional(64, 32, 2)


def item8_check_cases() -> tuple:
    """``item8_checks``' renders against the CPU: (name, description,
    spp, the name of the check whose CPU image scales its gates or None,
    environment)."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        SPECTRAL_CONDUCTOR, cbox_polarized, cornell_box)
    ior = ior_env()
    return (
        ('cbox_spectral', _PREP['spectral64'], 4, None, ior),
        ('cbox_polarized_s0', cbox_polarized(
            64, 2, 0, conductor=SPECTRAL_CONDUCTOR), 2, None, ior),
        ('cbox_polarized_s1', cbox_polarized(
            64, 2, 1, conductor=SPECTRAL_CONDUCTOR), 2,
         'cbox_polarized_s0', ior),
        ('cbox_spectral_polarized_s0', cbox_polarized(
            64, 2, 0, spectral=True, conductor=SPECTRAL_CONDUCTOR), 2, None,
         ior),
        ('cbox_spectral_polarized_s3', cbox_polarized(
            64, 2, 3, spectral=True, conductor=SPECTRAL_CONDUCTOR), 2,
         'cbox_spectral_polarized_s0', ior),
        *((f'aov_{kind}', cornell_box(spp=2, res=64, integrator={
            'type': 'aov', 'aovs': f'x:{kind}'}), 2, np.ones((64, 64, 3)),
           ()) for kind in ('sh_normal', 'position', 'uv')),
        ('moment_path', cornell_box(spp=4, res=64, integrator={
            'type': 'moment', 'integrator': {'type': 'path',
                                             'max_depth': 8}}), 4, None, ()),
        ('albedo_grid', albedo_grid_desc(), 2, None, ()),
        ('regen_fog', cornell_box(
            spp=2, res=64, medium={'type': 'homogeneous', 'sigma_t': 0.5,
                                   'albedo': 0.9},
            integrator={'type': 'volpath', 'max_depth': 8}), 2, None,
         REGEN_ENV))


def item10_check_cases() -> tuple:
    """``item10_checks``' renders against the CPU from files: (name,
    description, spp, the name of the check whose CPU image scales its
    gates or None)."""
    return (('cbox_measured', _PREP['measured64'], 2, None),
            ('cbox_measured_polarized_s0', _PREP['measured_pol64_s0'], 2,
             None),
            ('cbox_measured_polarized_s1', _PREP['measured_pol64_s1'], 2,
             'cbox_measured_polarized_s0'))


def double_check_desc() -> dict:
    desc = cbox_check_desc()
    desc['double'] = True
    return desc


def cpu_half_jobs() -> list:
    """The workers' jobs, in the order the phases reach them: the CPU
    halves of ``card_vs_cpu`` and ``mesh_card_vs_cpu``, of the volumetric
    checks, the two-pass checks (each at 2 spp), the materials checks,
    slice 7's, 8's and 10's checks and the CPU gradients of
    ``autodiff_checks``. A scene that reads files reads them from
    ``prepare_check_files``' directory."""
    return [(cpu_render_half, cbox_check_desc(), 4),
            (cpu_render_half, _PREP['mesh64'], 2),
            *((cpu_render_half, d, spp) for _, d, spp in vol_check_cases()),
            *((nlvrl_cpu_half, d, 2) for d in (
                nlvrl_check_desc('vrl'), nlvrl_check_desc('photonmapper'))),
            (cpu_render_half, materials_check_desc(), 4),
            *((nlvrl_cpu_half, d, 2) for d in (
                materials_pm_check_desc(),
                *(option_desc(o, hg, c, 64, 32, 1000)
                  for _, o, hg, c in option_cases()))),
            *((cpu_render_half, d, spp) for _, d, spp in item7_check_cases()),
            (nlvrl_cpu_half, spot_directional_desc(), 2),
            *((cpu_render_half, d, spp, env)
              for _, d, spp, _, env in item8_check_cases()),
            *((cpu_grad_half, (desc, keys), 1)
              for _, desc, keys, _ in autodiff_cases()),
            *((cpu_render_half, d, spp)
              for _, d, spp, _ in item10_check_cases()),
            (cpu_render_half, double_check_desc(), 4),
            (cpu_render_half, hetvol_spectral_desc(), HETVOL_CHECK_SPP),
            (nlvrl_cpu_half, nlvrl_check_desc('vrl', spectral=True), 2)]


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
    agree, _ = card_vs_cpu(mnt, compare, materials_check_desc(), 4)
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
    out.update(launches_textured=rec['launches'],
               textured_ms=own['ms_per_launch'],
               textured_plain_ms=own['plain_ms_per_launch'],
               textured_bound_ms=own['bound_ms_per_launch'],
               max_abs_err=own['max_abs_err'])
    textured_img, textured_rays = img_np, rec['rays']
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
    # the CLI on the textured file renders beside the phases below (after
    # the kernel's timed calls, which it would share the card with)
    exr = os.path.join(workdir, 'textured.exr')
    textured_cli = start_cli([path, '-o', exr, '-v'], timeout=400)
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
    stats = cli_check('textured_cli', textured_cli, exr, textured_img,
                      textured_rays)
    out['launches_textured_cli'] = stats['kernel_launches']
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

    for name, desc, spp in item7_check_cases():
        half = {}
        agree, _ = card_vs_cpu(mnt, compare, desc, spp, half=half)
        emit({'phase': 'item7_checks', 'check': name, 'spp': spp, **agree,
              **half})
        compare.check(agree)
    agree, own_maps = nlvrl_card_vs_cpu(mnt, compare,
                                        spot_directional_desc(), 2)
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
    out['launches_spectral'] = rec['launches']
    spectral_img, spectral_rays = img_np, rec['rays']
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
        # the last timed kernel calls of the slice: the CLI's --spectral
        # render and the regeneration check start beside what follows
        exr = os.path.join(workdir, 'spectral.exr')
        with environ((('MNT_REGEN', '0'),)):
            spectral_cli = start_cli([path, '-o', exr, '--spectral', '-v'],
                                     timeout=400)
        start_card_job('regen_vs_pass_loop')
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
    stats = cli_check('spectral_cli', spectral_cli, exr, spectral_img,
                      spectral_rays)
    out['launches_spectral_cli'] = stats['kernel_launches']
    return out


def item8_checks(torch, mnt, compare, workdir) -> None:
    """Slice 8 on the card against the CPU (``compare.check`` on each, at
    64x64): cbox_spectral; cbox_polarized components 0 and 1 and its
    spectral component 3 (S1 and S3 gated against S0); ``aov`` with
    sh_normal, position and uv; ``moment`` around ``path``; a
    heterogeneous box with an albedo gridvolume; regeneration on a
    homogeneous-fog box (card regen against CPU regen). Regeneration
    against the pass loop runs beside the phases (``regen_check``)."""
    images = {}
    for name, desc, spp, scale, env in item8_check_cases():
        half = {}
        with environ(env):
            agree, images[name] = card_vs_cpu(
                mnt, compare, desc, spp,
                images[scale] if isinstance(scale, str) else scale, half,
                env)
        emit({'phase': 'item8_checks', 'check': name, 'spp': spp, **agree,
              **half})
        compare.check(agree)


def regen_check() -> None:
    """``item8_checks``' regeneration against the pass loop on the card
    (a 64x64 heterogeneous box, 4 spp), computed in a process of its own
    beside the phases since ``regen_render`` (``regen_vs_pass_loop``): on
    two seeds the reference's noise rule (the gap between the schedulers'
    images under 1.5 times the seed-to-seed noise, the means within 8%);
    on four, with the regeneration's film jitter salted by the seed, the
    means within 6 standard errors over seeds."""
    rec, job = take_card_job('regen_vs_pass_loop')
    emit({'phase': 'item8_checks', 'check': 'regen_vs_pass_loop',
          'scene': 'hetvol_box 64x64, sigma_t x5', 'spp': 4, **rec, **job})
    assert rec['regen_finite'] and rec['cross'] < 1.5 * rec['noise'], rec
    assert rec['mean_rel'] < 0.08, rec
    assert rec['salted_finite'] and \
        abs(rec['salted_gap']) < 6 * rec['salted_se'], rec


def regen_vs_pass_loop() -> dict:
    """Regeneration against the pass loop on the card (a 64x64
    heterogeneous box, 4 spp): the numbers of ``item8_checks``' noise rule
    (two seeds) and salted-seed rule (four), and whether the images are
    finite. It needs nothing of the phases before it, so it runs in a
    process of its own beside them (``start_card_job``)."""
    import numpy as np
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.integrators import regen as regen_mod
    from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box
    os.environ['MNT_REGEN'] = '1'
    try:
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
    return {'seeds': list(seeds[:2]), 'noise': noise, 'cross': cross,
            'mean_rel': rel, 'regen_finite': bool(np.isfinite(regen).all()),
            'salted_seeds': list(seeds), 'salted_gap': gap,
            'salted_rel': gap / float(m_loop.mean()), 'salted_se': se,
            'salted_z': gap / se,
            'salted_finite': bool(np.isfinite(salted).all())}



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


def autodiff_cases() -> tuple:
    """``autodiff_checks``' cases: (name, description, parameter keys,
    absolute tolerance)."""
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (
        cornell_box, dress_materials, hetvol_box)
    return (
        ('cbox_path_64', cornell_box(spp=1, res=64, integrator={
            'type': 'path', 'max_depth': 8}),
         ('bsdfs.params', 'emitters.params'), 1e-6),
        ('cbox_materials_64', dress_materials(cornell_box(
            spp=1, res=64, integrator={'type': 'path', 'max_depth': 3})),
         ('bsdfs.params',), 1e-6),
        ('hetvol_24', hetvol_box(24, 24, spp=1, grid_res=16, seed=0,
                                 scale=20.0, max_depth=AD_CHECK_DEPTH),
         ('media.params', 'media.grid_sigma_t'), 1e-5))


def scene_gradient(torch, mnt, desc, keys, device) -> tuple:
    """(the image, the gradient of sum(image * W) for a seeded W with
    respect to each of ``keys``) of ``desc`` rendered at 1 spp on
    ``device``, as numpy."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import autodiff as ad
    scene, meta = mnt.build_scene(desc, device=device)
    pm = ad.traverse(scene).keep(keys)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pm.to_dict().items()}
    img = ad.render(scene, meta, params=params, pmap=pm, spp=1, seed=0)
    W = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(img.shape)).astype(np.float32), device=device)
    (img * W).sum().backward()
    return (img.detach().cpu().numpy(),
            {k: v.grad.cpu().numpy() for k, v in params.items()})


def cpu_grad_half(case, spp) -> tuple:
    """The CPU's half of an ``autodiff_checks`` case ((description,
    keys); ``spp`` is 1): ``scene_gradient`` on the CPU."""
    import torch
    import mitsuba_nlvrl_tpu_torch as mnt
    desc, keys = case
    assert spp == 1, spp
    return scene_gradient(torch, mnt, desc, keys, 'cpu')


def autodiff_checks(torch, mnt) -> None:
    """The card's gradients against the CPU's on reduced scenes: the
    Cornell box at 64x64 (``path`` max_depth 8: bsdfs.params and
    emitters.params) and ``hetvol_box`` at 24x24 with a 16^3 grid
    (sigma_t x20 as in the CPU parity tests, ``volpath`` at the CPU
    test's max_depth 3, AD_CHECK_DEPTH; media.params,
    media.grid_sigma_t), each the gradient of sum(image * W) for a seeded
    W, and the materials box at 64x64 (``path`` max_depth 3, every
    microfacet and plastic BSDF: bsdfs.params, finite in every entry on
    both devices, slice 11). The images agree within 1e-5 relative. Each
    gradient entry is held
    to the CPU tests' tolerance (1e-4 relative plus 1e-6 or 1e-5); the
    card's transcendentals differ from the CPU's by ulps, so a lane whose
    walk turns on one takes another decision, and as the render gates
    allow such lanes, at most one entry in a thousand (and one at least)
    may fall outside, their error summing to 1e-4 of the gradient's
    absolute sum at most."""
    import numpy as np
    for name, desc, keys, atol in autodiff_cases():
        t0 = time.time()
        out = {'cuda': scene_gradient(torch, mnt, desc, keys, 'cuda')}
        card_s = time.time() - t0
        out['cpu'], half = take_cpu_half(cpu_grad_half, (desc, keys), 1)
        img_g, g_g = out['cuda']
        img_c, g_c = out['cpu']
        rec = {'check': name, 'card_s': card_s, **half,
               'image_max_abs_err': float(np.abs(img_g - img_c).max())}
        for k in keys:
            err = np.abs(g_g[k] - g_c[k])
            outside = err > atol + 1e-4 * np.abs(g_c[k])
            rec[k] = {'max_abs_err': float(err.max()),
                      'abs_sum': float(np.abs(g_c[k]).sum()),
                      'entries': int(err.size),
                      'outside_tolerance': int(outside.sum()),
                      'outside_err_sum': float(err[outside].sum()),
                      'finite': bool(np.isfinite(g_g[k]).all()),
                      'cpu_finite': bool(np.isfinite(g_c[k]).all())}
        emit({'phase': 'autodiff_checks', **rec})
        np.testing.assert_allclose(img_g, img_c, rtol=1e-5, atol=1e-6)
        for k in keys:
            r = rec[k]
            assert r['finite'] and r['cpu_finite'] and r['abs_sum'] > 0, \
                (k, rec)
            assert r['outside_tolerance'] <= max(1, r['entries'] // 1000), \
                (k, rec)
            assert r['outside_err_sum'] <= 1e-4 * r['abs_sum'], (k, rec)


def start_cli(args, timeout: float):
    """Start ``python -m mitsuba_nlvrl_tpu_torch`` in a subprocess from
    this checkout, under this process's environment as it stands; the
    phases go on beside it. Returns a function that waits for it and
    gives (wall s, stdout), failing on a non-zero exit or the timeout."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, '-m', 'mitsuba_nlvrl_tpu_torch',
                             *args], cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _children.append(proc)

    def finish():
        try:
            out, err = proc.communicate(timeout=max(1.0, t0 + timeout
                                                    - time.time()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, (proc.returncode, out[-2000:],
                                      err[-4000:])
        return time.time() - t0, out
    return finish


def cli_check(phase: str, finish, exr: str, img_np, rays) -> dict:
    """Wait for a CLI render (``start_cli``) and hold its EXR to the
    in-process render of the same scene file, seed and device: the same
    image in every bit and the same rays. Returns the CLI's stats."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.utils.io import read_exr
    wall, cli_out = finish()
    stats = json.loads([x for x in cli_out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    im, names = read_exr(exr)
    cli_img = im[..., [names.index(c) for c in 'RGB']]
    emit({'phase': phase, 'process_wall_s': wall,
          'render_s': stats['render_s'], 'rays': stats['rays'],
          'mrays_per_s': stats['mrays_per_s'],
          'launches': stats['kernel_launches'],
          'host_syncs': stats['host_syncs'],
          'bit_equal_in_process': cli_img.tobytes() == img_np.tobytes(),
          'finite': bool(np.isfinite(cli_img).all()),
          'mean': float(cli_img.mean())})
    assert cli_img.tobytes() == img_np.tobytes(), \
        f"{phase}: the CLI's EXR differs from the in-process render"
    assert stats['rays'] == rays, (stats['rays'], rays)
    return stats


_children = []


def stop_children() -> None:
    """Kill the CLI subprocesses still running (a phase failed)."""
    for proc in _children:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    _children.clear()


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
    # the CLI renders beside the mesh phases; it is checked after them
    exr = os.path.join(workdir, 'cbox.exr')
    scene_cli = start_cli([path, '-o', exr, '-v'], timeout=300)
    # the render phase's scene again, pass by pass, for the z-test
    ref, ref_passes, ref_rays = compare.render_with_passes(scene, meta, 0, 16)

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
    # (the same scene, written before the CPU workers started)
    half = {}
    agree, _ = card_vs_cpu(mnt, compare, _PREP['mesh64'], 2, half=half)
    emit({'phase': 'mesh_card_vs_cpu', 'res': 64, 'spp': 2, **agree,
          **half})
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

    # --- scene_file: the CLI's EXR against the render phase's scene ----
    wall, out = scene_cli()
    stats = json.loads([x for x in out.splitlines()
                        if x.startswith('[stats] ')][0][len('[stats] '):])
    cli_img = rgb(exr)
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
    return stats['kernel_launches'], c['kernel_launches']


# triangles the float64 kernel keeps whole in shared memory
# (kWholeMaxTris in csrc/intersect_f64.cu); above it they stream through
# a ring
WHOLE_SET_CAP_F64 = 512


def f64_cases(torch, kern, scene, meta) -> dict:
    """The float64 kernel's cases, {name: (tris, rays)}: the double
    scene's camera rays, random rays against 1,023 random triangles (the
    timed shape bound by operations), and its edges: ties, ragged counts,
    the whole-set cap and the ring above it, grids one tile short of or
    over the resident blocks, ray arrays 8 bytes off a 16-byte boundary,
    bounded t, scenes scaled by 1e80 and 1e-5 (det near 1e160 and
    1e-10, against the 1e-12 threshold), and no triangles."""
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

    def scaled(tris, rays, s):
        return (tuple(x * s for x in tris),
                (rays[0] * s, rays[1], rays[2] * s, rays[3]))

    ties = tuple(torch.cat([x, x]).contiguous() for x in random_tris(300))
    cap = WHOLE_SET_CAP_F64
    geo = kern.geometry(1 << 28, 100, dtype=f64)
    tile, resident = geo.ray_tile, geo.grid
    ring_grid = kern.geometry(1 << 28, cap + 1, dtype=f64).grid
    shifted = tuple(x[1:] for x in random_rays(65537))
    assert shifted[0].data_ptr() % 16 == 8 and shifted[2].data_ptr() % 16 == 8
    bounded = random_rays(65536)
    bounded = (bounded[0], bounded[1], rand(65536, lo=0.0, hi=2.0),
               rand(65536, lo=1.0, hi=4.0))
    some = random_tris(300)
    return {'cbox_camera_512': (box, cam_rays),
            'random_1023': (random_tris(1023), random_rays(262144)),
            'random_1000': (random_tris(1000), random_rays(65536)),
            'ties_600': (ties, random_rays(65536)),
            'ragged_n': (random_tris(257), random_rays(100003)),
            'zero_tris': (tuple(torch.zeros((0, 3), device=dev, dtype=f64)
                                for _ in range(3)), random_rays(4099)),
            'n_1': (some, random_rays(1)),
            'n_255': (some, random_rays(255)),
            'n_257': (some, random_rays(257)),
            f'whole_cap_{cap}': (random_tris(cap), random_rays(65536)),
            f'ring_{cap + 1}': (random_tris(cap + 1),
                                random_rays(tile * ring_grid + 1)),
            'grid_tiles_minus_1': (random_tris(100),
                                   random_rays(tile * resident - 1)),
            'grid_tiles_plus_1': (random_tris(100),
                                  random_rays(tile * resident + 1)),
            'misaligned_8b': (some, shifted),
            'bounded_t': (some, bounded),
            'scaled_1e80': scaled(some, random_rays(65536), 1e80),
            'scaled_1e-5': scaled(some, random_rays(65536), 1e-5)}


def kernel_f64_phases(torch, kern, scene, meta, bw, fl64) -> dict:
    """The float64 kernel against its float64 plain version on every case
    of ``f64_cases``, nearest and any hit, equal in bits (any hit: the
    smallest hit t); then its time at 262,144 camera rays x 12 triangles
    and at 262,144 random rays x 1,023 random triangles against the bound
    (bytes over the memory rate, FLOPS_PER_PAIR a pair over the fp64
    rate), with the launch it makes."""
    cases = f64_cases(torch, kern, scene, meta)
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
    times = {}
    for shape in ('cbox_camera_512', 'random_1023'):
        tris, rays = cases[shape]
        N, T = rays[0].shape[0], tris[0].shape[0]
        ms = time_ms(lambda: kern.intersect_tris(*tris, *rays), 7, 50)
        ms_any = time_ms(lambda: kern.intersect_tris(*tris, *rays,
                                                     any_hit=True), 7, 50)
        plain_ms = time_ms(lambda: kern.intersect_tris_plain(*tris, *rays),
                           5, 3)
        nbytes, nops, b_bytes, b_ops = bound(N, T, False, bw, fl64, 8)
        _, _, b_bytes_any, _ = bound(N, T, True, bw, fl64, 8)
        bound_ms = max(b_bytes, b_ops)
        geo = kern.geometry(N, T, dtype=torch.float64)
        times[shape] = {
            'rays': N, 'tris': T, 'ms': ms, 'ms_any_hit': ms_any,
            'plain_ms': plain_ms, 'bytes': nbytes, 'flops': nops,
            'fp64_flops_per_s': fl64, 'bound_ms': bound_ms,
            'bound_bytes_ms': b_bytes, 'bound_ops_ms': b_ops,
            'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
            'roofline_share': bound_ms / ms,
            'roofline_share_any_hit': max(b_bytes_any, b_ops) / ms_any,
            'grid': geo.grid, 'smem_bytes': geo.smem_bytes,
            'ring': geo.ring, 'ray_tile': geo.ray_tile}
    return {'checks': checks, 'max_abs_err': worst, 'time': times}


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
    measured_path = path
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
    out['launches_measured'] = rec['launches']
    measured_img, measured_rays = img_np, rec['rays']
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
    for shape, rec in k64['time'].items():
        out.update({f'f64_{shape}_{k}': rec[k] for k in (
            'ms', 'ms_any_hit', 'plain_ms', 'bound_ms', 'bound_by')})
    calls = record_calls(mnt, dscene, dmeta)
    assert [c[2] for c in calls] == [False, True] * 8, len(calls)
    assert all(r.dtype == torch.float64 for _, rays, _ in calls
               for r in rays)
    own64 = render_rays(torch, kern, calls, bw, fl, fl64=fl64)
    emit({'phase': 'double_render_rays', **own64})
    # the last timed kernel calls of the slice: the CLI on the measured
    # file renders beside what follows
    exr = os.path.join(workdir, 'measured.exr')
    measured_cli = start_cli([measured_path, '-o', exr, '-v'], timeout=400)
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
    # every float64 call of the step, the recompute's too, held in bits
    with diff_step_check(torch, kern) as chk:
        img = ad.render(dscene, dmeta, params={'bsdfs.params': leaf},
                        pmap=pm, spp=1, seed=3)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
    g = leaf.grad
    grec = {'wall_s': time.time() - t0, 'loss': float(loss.detach()),
            'dtype': str(img.dtype), 'grad_finite': bool(g.isfinite().all()),
            'grad_abs_sum': float(g.abs().sum()),
            'launches_f64': kern.launches_f64,
            'launches_f64_recompute': kern.launches_f64_recompute,
            'bit_check': chk.done()}
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
    stats = cli_check('measured_cli', measured_cli, exr, measured_img,
                      measured_rays)
    out['launches_measured_cli'] = stats['kernel_launches']
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
    images = {}

    def gate(name, desc, spp, scale=None):
        half = {}
        agree, images[name] = card_vs_cpu(mnt, compare, desc, spp,
                                          images.get(scale), half)
        emit({'phase': 'item10_checks', 'check': name, 'spp': spp, **agree,
              **half})
        compare.check(agree)

    for name, desc, spp, scale in item10_check_cases():
        gate(name, desc, spp, scale)
    agree = double_card_vs_cpu(mnt, compare, double_check_desc(), 4)
    emit({'phase': 'item10_checks', 'check': 'cbox_path_double', 'spp': 4,
          'rtol': DOUBLE_RTOL, 'pixel_fraction': DOUBLE_PIXEL_FRACTION,
          'mean_rtol': DOUBLE_MEAN_RTOL, **agree})
    compare.check(agree)
    assert agree['dtype'] == agree['cpu_dtype'] == 'float64', agree
    assert agree['pixels_within_rtol'] >= DOUBLE_PIXEL_FRACTION, agree
    assert agree['mean_rel'] <= DOUBLE_MEAN_RTOL, agree
    assert agree['float32_pixels_within_rtol'] < DOUBLE_PIXEL_FRACTION, agree
    assert agree['float32_mean_rel'] > DOUBLE_MEAN_RTOL, agree
    gate('hetvol_volpath_spectral', hetvol_spectral_desc(), HETVOL_CHECK_SPP)
    agree, own_maps = nlvrl_card_vs_cpu(
        mnt, compare, nlvrl_check_desc('vrl', spectral=True), 2)
    emit({'phase': 'item10_checks', 'check': 'cbox_nlvrl_vrl_spectral',
          **agree, 'own_maps': own_maps})
    compare.check(agree)
    assert own_maps['card_finite'] and own_maps['mean_rel'] <= 0.05, \
        own_maps



def integrator_keyword_check(torch, mnt, kern) -> dict:
    """``render(..., integrator='depth')`` on the card (slice 11): the
    64x64 box built for ``path`` rendered with the ``depth`` integrator
    equals in bits the box built for ``depth``, both on the card, and
    99% of its pixels are within 1e-5 relative of the CPU's (the card's
    sin and cos part from the CPU's by an ulp, so an edge ray may meet
    another triangle)."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    desc = cornell_box(spp=2, res=64, integrator={'type': 'path',
                                                  'max_depth': 8})
    depth_desc = cornell_box(spp=2, res=64, integrator={'type': 'depth'})
    kern.launches = 0
    sg, mg = mnt.build_scene(desc)
    img = mnt.render(sg, mg, seed=0, integrator='depth')
    sd, md = mnt.build_scene(depth_desc)
    own = mnt.render(sd, md, seed=0)
    torch.cuda.synchronize()
    launches = kern.launches
    sc, mc = mnt.build_scene(desc, device='cpu')
    cpu = mnt.render(sc, mc, seed=0, integrator='depth').numpy()
    got = img.cpu().numpy()
    rel = np.abs(got - cpu) / np.maximum(np.abs(cpu), 1e-6)
    rec = {'equal_to_depth_scene': bool(torch.equal(img, own)),
           'pixels_within_1e-5': float((rel <= 1e-5).mean()),
           'max_depth_value': float(got.max()), 'launches': launches,
           'finite': bool(np.isfinite(got).all())}
    emit({'phase': 'integrator_keyword', 'res': 64, 'spp': 2, **rec})
    assert rec['equal_to_depth_scene'] and rec['finite'], rec
    assert rec['pixels_within_1e-5'] >= 0.99 and launches > 0, rec
    assert rec['max_depth_value'] > 1.0, rec
    return rec


# slice 12's sizes (PERF.md §4): measure_fold's film, the reference's
# per-chip shard (32,768 pixels), and its folds; the weak-scaling sweep's
# wavefronts (32,768 lanes times each factor), which set
# render_dist.SATURATION_LANES
FOLD_FILM = (256, 128)
FOLD_FOLDS = 8
WEAK_BASE = 32768
WEAK_FACTORS = (1, 2, 4, 8, 16, 32, 64, 128)
# the share of the sweep's best rate at which a wavefront counts as
# saturating the card
SATURATION_SHARE = 0.9
_DIST_STORE = []


def dist_init_phase(torch):
    """``dist_init``: the process group on NCCL at world size 1, joined
    through a file store in a temporary directory, and a ``dp`` mesh over
    it. NCCL bootstraps over a socket even alone, so the script names the
    loopback interface (NCCL_SOCKET_IFNAME=lo) unless the caller set
    one: it then needs no network. One all-reduce checks the group.
    There is no gloo stand-in: if NCCL fails, the script fails."""
    import torch.distributed as dist
    from mitsuba_nlvrl_tpu_torch.parallel import (collectives, render_dist,
                                                  scaling)
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    store = tempfile.mkdtemp(prefix='chip_smoke_dist_')
    _DIST_STORE.append(store)
    t0 = time.time()
    rank = scaling.init_distributed(f'file://{store}/store', 1, 0)
    mesh = render_dist.make_mesh()
    x = torch.arange(8, dtype=torch.float32, device='cuda')
    y = collectives.all_reduce_sum(x, mesh.get_group('dp'))
    torch.cuda.synchronize()
    rec = {'backend': str(dist.get_backend()),
           'nccl_version': '.'.join(str(v) for v in torch.cuda.nccl.version()),
           'world_size': dist.get_world_size(), 'rank': rank,
           'nccl_socket_ifname': os.environ['NCCL_SOCKET_IFNAME'],
           'seconds': time.time() - t0, 'all_reduce_ok': bool(torch.equal(
               x, y))}
    emit({'phase': 'dist_init', **rec})
    assert rec['backend'] == 'nccl' and rec['all_reduce_ok'], rec
    return mesh


def end_distributed() -> None:
    """Leave the process group (the script's ``finally``) and remove its
    store."""
    if 'torch.distributed' in sys.modules:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    while _DIST_STORE:
        shutil.rmtree(_DIST_STORE.pop(), ignore_errors=True)


def dist_render_phases(torch, mnt, kern, compare, bw, fl, mesh, scene, meta,
                       render_wall) -> dict:
    """``dist_render_rays``: every kernel call of one dispatch of
    ``render_distributed`` on cbox_path (512x512, the fold that
    ``dp_fold_for`` picks) against the plain version, bit for bit, and
    timed; ``dist_render``: the 16 spp render through the NCCL mesh of
    one rank (wall, the all-reduced rays, launches: 16 a dispatch,
    all-reduces and their device time from CUDA events) beside the
    ``render`` phase's wall; ``dist_card_vs_cpu``: a 64x64, 4 spp
    ``render_distributed`` on the card against the CPU's (no group),
    ``compare.check`` (the z-test's variance from the CPU's passes of
    ``render``: the same estimator a pixel)."""
    from mitsuba_nlvrl_tpu_torch.parallel import collectives
    from mitsuba_nlvrl_tpu_torch.parallel import render_dist as rd
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    fold = rd.dp_fold_for(meta, mesh, 16)
    calls = record_calls(mnt, scene, meta, run=lambda: rd.render_distributed(
        scene, meta, mesh, seed=0, spp=fold, fold=fold))
    assert [c[2] for c in calls] == [False, True] * 8, len(calls)
    own = render_rays(torch, kern, calls, bw, fl)
    lanes = calls[0][1][0].shape[0]
    del calls
    emit({'phase': 'dist_render_rays', 'fold': fold, 'lanes': lanes, **own})

    torch.cuda.synchronize()
    kern.launches = 0
    collectives.reset()
    info = {}
    t0 = time.time()
    with collectives.timed() as events:
        img = rd.render_distributed(scene, meta, mesh, seed=0, spp=16,
                                    info=info)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kern.launches
    rays = float(info['rays'])
    img_np = img.cpu().numpy()
    rec = {'res': 512, 'spp': 16, 'max_depth': 8, 'fold': info['fold'],
           'dispatches': info['dispatches'], 'wall_s': wall, 'rays': rays,
           'mrays_per_s': rays / wall / 1e6, 'launches': launches,
           'all_reduces': info['all_reduces'],
           'nccl_s': collectives.elapsed_s(events),
           'render_wall_s': render_wall,
           'finite': bool(img.isfinite().all()),
           'mean': float(img_np.mean())}
    emit({'phase': 'dist_render', **rec})
    assert info['dispatches'] == -(-16 // fold), rec
    assert launches == 16 * info['dispatches'], rec
    assert rec['all_reduces'] == info['dispatches'] + 1, rec
    assert rec['finite'] and 0.01 < rec['mean'] < 10.0, rec

    desc = cornell_box(spp=4, res=64, integrator={'type': 'path',
                                                  'max_depth': 8})
    sg, mg = mnt.build_scene(desc)
    sc, mc = mnt.build_scene(desc, device='cpu')
    ig, ic = {}, {}
    img_g = rd.render_distributed(sg, mg, mesh, seed=0, spp=4, info=ig)
    img_c = rd.render_distributed(sc, mc, None, seed=0, spp=4, info=ic)
    _, passes_c, _ = compare.render_with_passes(sc, mc, 0, 4)
    agree = compare.agreement(img_g.cpu().numpy(), img_c.numpy(), passes_c,
                              float(ig['rays']), float(ic['rays']))
    emit({'phase': 'dist_card_vs_cpu', 'res': 64, 'spp': 4,
          'fold': ig['fold'], **agree})
    compare.check(agree)
    return {'launches': launches, 'rays': own}


def fold_and_scaling_phases(torch, mnt, mesh, scene, meta) -> dict:
    """``measure_fold`` at the reference's per-chip shard (a 256x128 film
    of cbox_path, folds 8, reps 3, through the NCCL mesh of one rank);
    then on cbox_path itself the steady render rate that bounds every
    rate (``scaling.PLAUSIBLE_FACTOR`` times it, scaled by a wavefront's
    lanes over the film's pixels: ``scaling.lane_bound``),
    ``dp_fold_proxy``,
    ``weak_scaling_proxy`` over WEAK_BASE x WEAK_FACTORS lanes (the
    smallest wavefront within SATURATION_SHARE of the sweep's best rate
    is the card's saturation, ``render_dist.SATURATION_LANES``) and
    ``measure_scaling`` at n = 1. A rate outside its bound raises."""
    from mitsuba_nlvrl_tpu_torch.parallel import render_dist as rd
    from mitsuba_nlvrl_tpu_torch.parallel import scaling
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cbox_light_spd,
                                                        cornell_box)
    desc = cornell_box(spp=FOLD_FOLDS, res=FOLD_FILM[0],
                       integrator={'type': 'path', 'max_depth': 8},
                       radiance=cbox_light_spd())
    desc['sensor']['film']['height'] = FOLD_FILM[1]
    fs, fm = mnt.build_scene(desc)
    rec = rd.measure_fold(fs, fm, folds=FOLD_FOLDS, reps=3, mesh=mesh)
    emit({'phase': 'measure_fold', **rec})
    assert rec['pixels'] == FOLD_FILM[0] * FOLD_FILM[1], rec
    assert all(rec[k] > 0 for k in ('latency_fold_s', 'wall_fold_s',
                                    'wall_nofold_s', 'kernel_s', 'ratio',
                                    'speedup')), rec

    t0 = time.time()
    steady = scaling.steady_render_rate(scene, meta)
    ceiling = scaling.PLAUSIBLE_FACTOR * steady
    fp = scaling.dp_fold_proxy(scene, meta, ceiling=ceiling)
    emit({'phase': 'dp_fold_proxy', 'steady_mrays': steady / 1e6, **fp,
          'seconds': time.time() - t0})
    t0 = time.time()
    ws = scaling.weak_scaling_proxy(scene, meta, base=WEAK_BASE,
                                    factors=WEAK_FACTORS, ceiling=ceiling)
    best = max(ws['rays_per_s'])
    sat = min(n for n, r in zip(ws['sizes'], ws['rays_per_s'])
              if r >= SATURATION_SHARE * best)
    emit({'phase': 'weak_scaling_proxy', 'steady_mrays': steady / 1e6, **ws,
          'saturation_lanes': sat,
          'saturation_lanes_in_code': rd.SATURATION_LANES,
          'seconds': time.time() - t0})
    t0 = time.time()
    ms = scaling.measure_scaling(scene, meta, n_devices=1, ceiling=ceiling)
    emit({'phase': 'measure_scaling', **ms, 'seconds': time.time() - t0})
    assert ms['hardware_valid'] and ms['n'] == 1, ms
    assert ms['checksum_rel_diff'] < 1e-5, ms
    return {'saturation_lanes': sat}


def sharded_vrl_phase(torch, mnt, kern, bw, fl, nscene, nmeta,
                      nmaps) -> dict:
    """``sharded_vrl_pass``: one camera pass of cbox_nlvrl (512x256, the
    ``nlvrl`` phase's maps) through ``make_sharded_vrl_render`` on a 1x1
    (dp x mp) NCCL mesh, its kernel calls kept: each against the plain
    version, bit for bit (every k-th timed alone); its radiance equal in
    bits to the same pass run unsharded on the localized maps with the
    same key (at one rank the all-reduce is the identity); its
    all-reduces and their device time (CUDA events), launches and wall
    (the copies of the calls' rays included) beside the unsharded
    pass's."""
    from mitsuba_nlvrl_tpu_torch import sensor as sensor_mod
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.core.rng import Sampler
    from mitsuba_nlvrl_tpu_torch.integrators import vrl as vrl_mod
    from mitsuba_nlvrl_tpu_torch.integrators.common import (
        film_sample_positions)
    from mitsuba_nlvrl_tpu_torch.parallel import collectives
    from mitsuba_nlvrl_tpu_torch.parallel import render_dist as rd
    from mitsuba_nlvrl_tpu_torch.parallel import sharded_maps as sm
    dev = nscene.device
    mesh = rd.make_mesh('cuda', (1, 1), ('dp', 'mp'))
    key = rng.PRNGKey(0)
    pos_key = rng.fold_in(key, 7)
    _, pos01 = film_sample_positions(nmeta, pos_key, 0, dev)
    N = pos01.shape[0]
    ray, _ = sensor_mod.sample_ray(nscene, nmeta, pos01, rng.uniform(
        rng.fold_in(pos_key, 1), (N, 2), dev))
    fn = sm.make_sharded_vrl_render(nmeta, mesh)
    shard = sm.shard_photon_axis(nmaps, mesh)

    # the pass itself, timed, its calls kept (also the warm-up)
    torch.cuda.synchronize()
    kern.launches = 0
    collectives.reset()
    info, out = {}, []
    t0 = time.time()
    with collectives.timed() as events:
        calls = record_calls(mnt, nscene, nmeta, run=lambda: out.append(
            fn(nscene, shard, ray, key, info=info)))
        torch.cuda.synchronize()
    wall_sh = time.time() - t0
    launches = kern.launches
    nccl_s = collectives.elapsed_s(events)
    L_sh = out[0]
    stride = max(1, len(calls) // 32)
    own = render_rays(torch, kern, calls, bw, fl, stride=stride)
    n_calls = len(calls)
    del calls

    n_cl = int(nmeta.iprop('vrl_clusters', 1024))
    t0 = time.time()
    with torch.no_grad():
        local = sm.localize_maps(nscene, nmaps._replace(clusters=None))
        if bool(nmeta.iprop('use_light_cut', True)):
            local = local._replace(clusters=vrl_mod.build_vrl_clusters(
                nscene, local, n_cl))
        L_un, _, _ = vrl_mod.sample(nscene, nmeta, Sampler.make(
            rng.fold_in(key, 0), N, dev), ray, aux=local)
        L_un = torch.where(torch.isfinite(L_un), L_un, 0.0)
        torch.cuda.synchronize()
    wall_un = time.time() - t0
    rec = {'res': [512, 256], 'lanes': N, 'calls': n_calls,
           'all_reduces': info['all_reduces'], 'nccl_s': nccl_s,
           'nccl_ms_per_all_reduce': 1e3 * nccl_s / max(
               info['all_reduces'], 1),
           'wall_s': wall_sh, 'unsharded_wall_s': wall_un,
           'launches': launches, 'rays': float(info['rays']),
           'sampler_dim': info['sampler_dim'],
           'equal_to_unsharded': bool(torch.equal(L_sh, L_un)),
           'mean': float(L_sh.mean()), **own}
    emit({'phase': 'sharded_vrl_pass', **rec})
    assert rec['equal_to_unsharded'], rec
    assert rec['all_reduces'] > 0 and launches == n_calls > 0, rec
    assert rec['mean'] > 0, rec
    return {'launches': launches, 'rays': own}


def dist_train_step_phase(torch, mnt, kern) -> dict:
    """``dist_train_step``: ``render_dist.train_step`` (the L2 loss of a
    1 spp render against a grey target and its gradient with respect to
    bsdfs.params) on the 64x64 Cornell box (``path`` max_depth 8), every
    kernel call of it held in bits as it is made (the recompute's too),
    and the card's loss and gradient against the CPU's: the loss within
    1e-5 relative, the gradient to ``autodiff_checks``'s rule (1e-6 plus
    1e-4 relative, one entry in a thousand excepted)."""
    import numpy as np
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.parallel import render_dist as rd
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    desc = cornell_box(spp=1, res=64, integrator={'type': 'path',
                                                  'max_depth': 8})

    def merge(s, p):
        return s._replace(bsdfs=s.bsdfs._replace(params=p))

    out, secs = {}, {}
    for device in ('cuda', 'cpu'):
        s, m = mnt.build_scene(desc, device=device)
        target = torch.full((64, 64, 3), 0.2, device=device)
        t0 = time.time()
        if device == 'cuda':
            kern.launches = kern.launches_recompute = 0
            with diff_step_check(torch, kern) as chk:
                loss, g = rd.train_step(s, m, s.bsdfs.params, target,
                                        rng.PRNGKey(4), merge)
                torch.cuda.synchronize()
            check = chk.done()
            launches = kern.launches + kern.launches_recompute
        else:
            loss, g = rd.train_step(s, m, s.bsdfs.params, target,
                                    rng.PRNGKey(4), merge)
        secs[device] = time.time() - t0
        out[device] = (float(loss), g.cpu().numpy())
    (lg, gg), (lc, gc) = out['cuda'], out['cpu']
    err = np.abs(gg - gc)
    outside = err > 1e-6 + 1e-4 * np.abs(gc)
    rec = {'res': 64, 'spp': 1, 'card_s': secs['cuda'], 'cpu_s': secs['cpu'],
           'loss': lg, 'cpu_loss': lc, 'loss_rel': abs(lg - lc) / abs(lc),
           'grad_max_abs_err': float(err.max()),
           'grad_abs_sum': float(np.abs(gc).sum()), 'entries': int(err.size),
           'outside_tolerance': int(outside.sum()),
           'outside_err_sum': float(err[outside].sum()),
           'finite': bool(np.isfinite(gg).all()), 'launches': launches,
           'check': check}
    emit({'phase': 'dist_train_step', **rec})
    assert rec['finite'] and rec['grad_abs_sum'] > 0, rec
    assert rec['loss_rel'] <= 1e-5, rec
    assert rec['outside_tolerance'] <= max(1, rec['entries'] // 1000), rec
    assert rec['outside_err_sum'] <= 1e-4 * rec['grad_abs_sum'], rec
    return {'launches': launches}


def item12_phases(torch, mnt, kern, compare, bw, fl, scene, meta,
                  render_wall, nscene, nmeta, nmaps) -> dict:
    """Slice 12: the sharded paths on the card at world size 1, NCCL."""
    t0 = time.time()
    mesh = dist_init_phase(torch)
    dr = dist_render_phases(torch, mnt, kern, compare, bw, fl, mesh, scene,
                            meta, render_wall)
    sc = fold_and_scaling_phases(torch, mnt, mesh, scene, meta)
    sv = sharded_vrl_phase(torch, mnt, kern, bw, fl, nscene, nmeta, nmaps)
    ts = dist_train_step_phase(torch, mnt, kern)
    emit({'phase': 'item12_done', 'seconds': time.time() - t0})
    return {'launches_dist_render': dr['launches'],
            'launches_sharded_vrl_pass': sv['launches'],
            'launches_dist_train_step': ts['launches'],
            'max_abs_err': max(dr['rays']['max_abs_err'],
                               sv['rays']['max_abs_err']),
            'dist_ms': dr['rays']['ms_per_launch'],
            'dist_plain_ms': dr['rays']['plain_ms_per_launch'],
            'dist_bound_ms': dr['rays']['bound_ms_per_launch'],
            'sharded_vrl_ms': sv['rays']['ms_per_launch'],
            'sharded_vrl_plain_ms': sv['rays']['plain_ms_per_launch'],
            'sharded_vrl_bound_ms': sv['rays']['bound_ms_per_launch'],
            'saturation_lanes': sc['saturation_lanes']}

# the bitmap fixtures (``scripts/port_make_bitmaps.py``): every layout the
# port's decoders read, PIL's convert('RGB') bytes of each in
# ``pil_rgb.npz``, one 64x64 picture in seventeen lossless formats, and
# two 512x512 WebP files (a texture's size) with the SHA-256 digests of
# PIL's bytes
BITMAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                       'data', 'bitmaps')
WEBP_LARGE = os.path.join(os.path.dirname(BITMAPS), 'webp_large')
# JPEG and WebP at 2,048^2 and 4,096^2 with the digests of PIL's bytes
BITMAPS_LARGE = os.path.join(os.path.dirname(BITMAPS), 'bitmaps_large')
# files PIL refuses, with the exception class it raises (pil_errors.json)
BITMAPS_REFUSED = os.path.join(os.path.dirname(BITMAPS), 'bitmaps_refused')
PICTURE_FORMATS = ('png', 'bmp', 'tga', 'ppm', 'gif', 'tif', 'webp', 'qoi',
                   'sgi', 'pcx', 'dds', 'jp2', 'ico', 'psd', 'zstd.tif',
                   'ras', 'im')
# a 4,096^2 decode on the card's host must take less (ROADMAP A 12.8)
LARGE_DECODE_LIMIT_S = 3.0
# and a 2,048^2 LZW TIFF's or GIF's (ROADMAP A 12.9)
LZW_DECODE_LIMIT_S = 1.0
LZW_LARGE = ('tiff_lzw_2048.tif', 'gif_256_2048.gif', 'tiff_zstd_2048.tif',
             'sun_rle_2048.ras', 'flc_brun_lc_ss2_2048.flc')
# and a 2,048^2 irreversible (9/7) JPEG 2000 file's
J2K_DECODE_LIMIT_S = 2.0
J2K_LARGE = ('jp2_irreversible_2048.jp2',)


def _large_decode(texture, path, check) -> dict:
    """Decode one large file through the native path, check it, and time
    it: host milliseconds and per megapixel."""
    t = time.perf_counter()
    got = texture.read_rgb8(path)
    ms = (time.perf_counter() - t) * 1e3
    assert check(got), f"{path}: the port's decode differs from PIL's"
    mpix = got.shape[0] * got.shape[1] / 1e6
    assert got.shape[0] < 4096 or ms < LARGE_DECODE_LIMIT_S * 1e3, \
        f"{path}: {ms:.1f} ms for a 4,096^2 decode"
    assert os.path.basename(path) not in LZW_LARGE or \
        ms < LZW_DECODE_LIMIT_S * 1e3, f"{path}: {ms:.1f} ms"
    assert os.path.basename(path) not in J2K_LARGE or \
        ms < J2K_DECODE_LIMIT_S * 1e3, f"{path}: {ms:.1f} ms"
    return {'shape': list(got.shape), 'host_ms': ms,
            'host_ms_per_mpix': ms / mpix}


def bitmap_decode_phase(workdir) -> None:
    """``bitmap_decode``: every fixture decoded by the port (which uses no
    PIL) and held to PIL's stored bytes, the two 512x512 WebP files and
    every file of ``tests/data/bitmaps_large`` (2,048^2 and 4,096^2 JPEG
    and WebP; 2,048^2 LZW TIFF, GIF, JPEG-in-TIFF and G4 TIFF; 2,048^2
    DDS of seeded random BC1 and BC7 blocks, written into ``workdir``;
    2,048^2 irreversible and reversible JPEG 2000; PIL's 1,024^2 ICNS) to
    the digests of PIL's, and a 4,096^2 PNG written here by numpy with
    every row Paeth-filtered to its known pixels (the 4,096^2 JPEG's),
    each decode's host milliseconds beside it (and per megapixel for the
    large files; the seeded 2,048^2 RLE Sun raster and FLC and the
    seeded Photo CD file are written into ``workdir`` too). Every file of
    ``tests/data/bitmaps_refused`` (SGILog, WebP and 8-bit ThunderScan
    TIFFs, an unknown TIFF compression, the PSD files PIL refuses, the
    six formats PIL opens and cannot load and the refused files of the
    rest of its raster formats) raises the class PIL raised (a class of
    PIL's own: the builtin it derives from, and its name). It reports
    whether the standard library's ``lzma`` imported (LZMA TIFF needs it;
    there is no fallback).
    A decode failure, a 4,096^2 decode of 3 s or more, a 2,048^2 LZW
    TIFF, Zstandard TIFF, GIF, RLE Sun raster or FLC decode of 1 s or
    more, or a 2,048^2 irreversible JPEG 2000 decode of 2 s or more,
    raises."""
    import builtins
    import hashlib
    import numpy as np
    from mitsuba_nlvrl_tpu_torch import native, texture
    from mitsuba_nlvrl_tpu_torch.testing.bitmap_stages import (large_file,
                                                               png_filtered)
    t0 = time.time()
    try:
        import lzma  # noqa: F401 - LZMA TIFF needs it; no fallback
    except ImportError as e:
        emit({'phase': 'bitmap_decode', 'lzma_imported': False,
              'error': str(e)})
        raise
    want = np.load(os.path.join(BITMAPS, 'pil_rgb.npz'))
    host_ms = {}
    for name in want.files:
        t = time.perf_counter()
        got = texture.read_rgb8(os.path.join(BITMAPS, name))
        host_ms[name] = (time.perf_counter() - t) * 1e3
        assert got.dtype == np.uint8 and \
            got.tobytes() == want[name].tobytes(), \
            f"{name}: the port's decode differs from PIL's bytes"

    def digest_check(d):
        return lambda rgb: list(rgb.shape) == d['shape'] and hashlib.sha256(
            rgb.tobytes()).hexdigest() == d['sha256']
    decoded = {}
    for folder in (WEBP_LARGE, BITMAPS_LARGE):
        with open(os.path.join(folder, 'pil_rgb_sha256.json')) as f:
            digests = json.load(f)
        # the seeded DDS, Sun raster, FLC and Photo CD files are written
        # into workdir
        decoded[folder] = {name: _large_decode(
            texture, large_file(folder, name, d, workdir), digest_check(d))
            for name, d in sorted(digests.items())}
    # the 4,096^2 PNG: the baseline JPEG's pixels, every row Paeth
    pixels = texture.read_rgb8(os.path.join(BITMAPS_LARGE,
                                            'jpeg_baseline_4096.jpg'))
    png = os.path.join(workdir, 'png_paeth_4096.png')
    t = time.perf_counter()
    with open(png, 'wb') as f:
        f.write(png_filtered(pixels, filters=(4,)))
    write_s = time.perf_counter() - t
    decoded[BITMAPS_LARGE]['png_paeth_4096.png'] = _large_decode(
        texture, png, lambda rgb: np.array_equal(rgb, pixels))
    os.remove(png)
    with open(os.path.join(BITMAPS_REFUSED, 'pil_errors.json')) as f:
        refusals = json.load(f)
    refused = {}
    for name, pil in sorted(refusals.items()):
        # a class of PIL's own is held to the builtin it derives from
        # (UnidentifiedImageError: OSError), and to its name
        want_cls = getattr(builtins, pil.get('base', pil['error']), OSError)
        try:
            texture.read_rgb8(os.path.join(BITMAPS_REFUSED, name))
        except want_cls as e:
            assert 'base' not in pil or pil['base'] == 'OSError' or \
                type(e).__name__ == pil['error'], (name, e)
            refused[name] = type(e).__name__
        else:
            raise AssertionError(f"{name}: decoded where PIL raises "
                                 f"{pil['error']}")
    # slice 19's fixtures: LZMA, Zstandard, word-aligned RLE, ThunderScan,
    # JPEG in planes and CMYK, tiled YCbCr, PSD
    new19 = {k: v for k, v in host_ms.items() if k.startswith((
        'tiff_zstd', 'tiff_lzma', 'tiff_rlew', 'tiff_thunderscan',
        'tiff_jpeg_planar', 'tiff_jpeg_cmyk', 'tiff_jpeg_rgba',
        'tiff_jpeg_la', 'tiff_jpeg_min', 'tiff_ycbcr22_raw_tiles',
        'tiff_ycbcr11_raw_tiles', 'psd_', 'picture64.psd',
        'picture64.zstd'))}
    # slice 20's fixtures: the rest of PIL's raster formats
    new20 = {k: v for k, v in host_ms.items() if k.endswith((
        '.ras', '.blp', '.ftc', '.ftu', '.fits', '.spi', '.im', '.imt',
        '.msp', '.fli', '.flc', '.xbm', '.xpm', '.gbr', '.area', '.pxr',
        '.xv', '.dcx', '.iim'))}
    webp_ms = {k: v for k, v in host_ms.items() if k.endswith('.webp')}
    emit({'phase': 'bitmap_decode', 'files': len(host_ms),
          'all_equal_to_pil': True, 'host_ms': host_ms,
          'host_ms_total': sum(host_ms.values()),
          'lzma_imported': True,
          'slice19_files': len(new19),
          'slice19_host_ms_total': sum(new19.values()),
          'slice20_files': len(new20),
          'slice20_host_ms_total': sum(new20.values()),
          'refused_as_pil': refused,
          'webp_files': len(webp_ms), 'webp_host_ms_total':
          sum(webp_ms.values()), 'webp_large': decoded[WEBP_LARGE],
          'large_equal_to_pil_digests': True,
          'bitmaps_large': decoded[BITMAPS_LARGE],
          'png_paeth_4096_write_s': write_s,
          'host_cpu': native._cpu_model(), 'cpus': os.cpu_count(),
          'started_at_s': t0 - _T0, 'seconds': time.time() - t0})


def textured_large_phase(torch, mnt, kern, sync, workdir) -> int:
    """``textured_large``: ``cbox_textured`` (64x64, 1 spp, ``path`` at
    ``CUT_DEPTH``) built with the 2,048^2 baseline JPEG as every bitmap,
    then with the same pixels as a PNG whose every row is Paeth-filtered
    and as an LZW TIFF with predictor 2 (both written here: the JPEG's
    pixels take 4.5 MB as a compact LZW file), each rendered on the card:
    build seconds with the decodes' seconds apart, and the three images
    and ray counts equal in bits. Returns the renders' launches."""
    from mitsuba_nlvrl_tpu_torch import texture
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.bitmap_stages import (png_filtered,
                                                               tiff_lzw)
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_textured
    t0 = time.time()
    jpg = os.path.join(BITMAPS_LARGE, 'jpeg_baseline_2048.jpg')
    png = os.path.join(workdir, 'large_paeth.png')
    tif = os.path.join(workdir, 'large_lzw.tif')
    pixels = texture.read_rgb8(jpg)
    with open(png, 'wb') as f:
        f.write(png_filtered(pixels, filters=(4,)))
    with open(tif, 'wb') as f:
        f.write(tiff_lzw(pixels))
    del pixels
    read_rgb8, decode_s = texture.read_rgb8, []

    def timed_read(path):
        t = time.perf_counter()
        out = read_rgb8(path)
        decode_s.append(time.perf_counter() - t)
        return out
    renders, builds, launches = {}, {}, 0
    for fmt, bitmap in (('jpeg', jpg), ('png', png), ('tiff_lzw', tif)):
        path = cbox_textured(os.path.join(workdir, f'large_{fmt}'), spp=1,
                             res=64, max_depth=CUT_DEPTH, bitmap=bitmap)
        decode_s.clear()
        texture.read_rgb8 = timed_read
        try:
            t = time.time()
            scene, meta = mnt.build_scene(load_file(path))
            build_s = time.time() - t
        finally:
            texture.read_rgb8 = read_rgb8
        assert tuple(scene.textures.data.shape[1:3]) == (2048, 2048), fmt
        builds[fmt] = {'build_s': build_s, 'decode_s': sum(decode_s),
                       'decodes': len(decode_s)}
        rec, img = timed_render(torch, mnt, kern, sync, scene, meta, 1)
        assert rec['launches'] > 0 and rec['finite'], (fmt, rec)
        launches += rec['launches']
        renders[fmt] = (rec, img)
        del scene, meta
    jrec, jimg = renders['jpeg']
    same = {fmt: img.tobytes() == jimg.tobytes() and rec['rays'] ==
            jrec['rays'] for fmt, (rec, img) in renders.items()
            if fmt != 'jpeg'}
    emit({'phase': 'textured_large', 'res': 64, 'spp': 1,
          'max_depth': CUT_DEPTH, 'scene': 'cbox_textured',
          'bitmap': [2048, 2048], 'builds': builds,
          'equal_jpeg_png_render': same['png'],
          'equal_jpeg_tiff_lzw_render': same['tiff_lzw'],
          'tiff_lzw_bytes': os.path.getsize(tif), 'launches': launches,
          'rays': jrec['rays'], 'mean': jrec['mean'],
          'wall_s': {fmt: rec['wall_s'] for fmt, (rec, _) in
                     renders.items()},
          'started_at_s': t0 - _T0, 'seconds': time.time() - t0})
    assert all(same.values()), same
    return launches


def rng_wide_check(torch) -> None:
    """``rng_wide``: uniform draws at lanes of a wavefront whose draw
    holds more than 2^32 elements ((8, 2^28, 3): counters up to
    6,442,450,943, hashed as their high and low words), on the card and on
    the CPU, in float32 and float64: equal in bits. 262,144 lanes spread
    over the wavefront, its first, second and last among them."""
    from mitsuba_nlvrl_tpu_torch.core import rng
    t0 = time.time()
    total = 1 << 28
    spread = torch.arange(3, 1 << 18, dtype=torch.int64) * 1024 + 7
    ids = torch.cat([torch.tensor([0, 1, total - 1]), spread])
    key = rng.fold_in(rng.PRNGKey(7), 3)
    rec = {}
    for dtype in (torch.float32, torch.float64):
        draws = [rng.uniform(key, (8, ids.numel(), 3), device=dev,
                             dtype=dtype, lanes=rng.Lanes(ids, total),
                             axis=1).cpu() for dev in ('cuda', 'cpu')]
        same = draws[0].numpy().tobytes() == draws[1].numpy().tobytes()
        rec[str(dtype).split('.')[1]] = {
            'equal_in_bits': same, 'mean': float(draws[0].mean()),
            'min': float(draws[0].min()), 'max': float(draws[0].max())}
        assert same, dtype
        assert 0 <= float(draws[0].min()) and float(draws[0].max()) < 1
    emit({'phase': 'rng_wide', 'global_shape': [8, total, 3],
          'lanes': ids.numel(), 'max_counter': 24 * total - 1, **rec,
          'started_at_s': t0 - _T0, 'seconds': time.time() - t0})


def item13_phases(torch, mnt, kern, sync, workdir) -> dict:
    """Slices 13 to 20, the bitmap formats: ``bitmap_decode`` (above);
    ``textured_formats`` renders ``cbox_textured`` (64x64, 1 spp,
    ``path`` at ``CUT_DEPTH``: each render is paced by its launches) on
    the card once for each lossless copy of the 64x64 picture as its
    bitmaps (PNG, BMP, TGA, PPM, GIF, TIFF, WebP, QOI, SGI, PCX, DDS,
    reversible JPEG 2000, a PNG icon in ICO, an RLE PSD, a Zstandard
    TIFF, a 24-bit RLE Sun raster and an RGB IM file), each image and its
    rays equal in bits to the PNG copy's;
    then ``textured_large`` (above). Returns the renders' launches."""
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_textured
    bitmap_decode_phase(workdir)
    t0 = time.time()
    renders, launches = {}, 0
    for ext in PICTURE_FORMATS:
        path = cbox_textured(
            os.path.join(workdir, f'formats_{ext}'), spp=1, res=64,
            max_depth=CUT_DEPTH,
            bitmap=os.path.join(BITMAPS, f'picture64.{ext}'))
        scene, meta = mnt.build_scene(load_file(path))
        # every bitmap of the scene is the 64x64 picture
        assert tuple(scene.textures.data.shape[1:3]) == (64, 64), ext
        rec, img = timed_render(torch, mnt, kern, sync, scene, meta, 1)
        assert rec['launches'] > 0 and rec['finite'], (ext, rec)
        launches += rec['launches']
        renders[ext] = (rec, img)
    ref_rec, ref_img = renders['png']
    same = {ext: img.tobytes() == ref_img.tobytes() and
            rec['rays'] == ref_rec['rays'] for ext, (rec, img)
            in renders.items()}
    emit({'phase': 'textured_formats', 'res': 64, 'spp': 1,
          'max_depth': CUT_DEPTH, 'scene': 'cbox_textured',
          'formats': list(PICTURE_FORMATS),
          'equal_to_png_render': same, 'launches': launches,
          'rays': ref_rec['rays'], 'mean': ref_rec['mean'],
          'wall_s': {ext: rec['wall_s'] for ext, (rec, _) in
                     renders.items()},
          'started_at_s': t0 - _T0, 'seconds': time.time() - t0})
    assert all(same.values()), same
    return {'launches_textured_formats': launches,
            'launches_textured_large': textured_large_phase(
                torch, mnt, kern, sync, workdir)}


_PREP_DIR = None


def main() -> int:
    global _PREP_DIR
    _PREP_DIR = tempfile.mkdtemp(prefix='chip_smoke_prep_')
    try:
        return _main()
    finally:
        stop_children()
        stop_card_jobs()
        stop_cpu_halves()
        end_distributed()
        shutil.rmtree(_PREP_DIR, ignore_errors=True)


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
    t0 = time.time()
    prepare_check_files(_PREP_DIR)
    start_cpu_halves(cpu_half_jobs())
    # the main process's torch threads: the cores the workers leave
    torch.set_num_threads(max(1, (os.cpu_count() or 2)
                              - CPU_WORKERS * cpu_worker_threads()))
    emit({'phase': 'cpu_workers', 'workers': CPU_WORKERS,
          'threads_each': cpu_worker_threads(), 'cpus': os.cpu_count(),
          'affinity': len(os.sched_getaffinity(0)), 'jobs': len(_cpu_jobs),
          'prepare_s': time.time() - t0})

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
    half = {}
    agree, _ = card_vs_cpu(mnt, compare, cbox_check_desc(), 4, half=half)
    emit({'phase': 'card_vs_cpu', **agree, **half})
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
    for scene_name, desc, spp in vol_check_cases():
        half = {}
        agree, _ = card_vs_cpu(mnt, compare, desc, spp, half=half)
        emit({'phase': 'vol_card_vs_cpu', 'scene': scene_name, 'spp': spp,
              **agree, **half})
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
    regen_check()
    # --- slice 10: measured BSDFs, float64, the spectral fallback -------
    workdir = tempfile.mkdtemp(prefix='chip_smoke_item10_')
    try:
        it10 = item10_phases(torch, mnt, kern, compare, sync, bw, fl, fl64,
                             workdir, wall)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # --- slice 11: the integrator= keyword -----------------------------
    integrator_keyword_check(torch, mnt, kern)
    # --- slice 12: the sharded paths at world size 1, NCCL --------------
    it12 = item12_phases(torch, mnt, kern, compare, bw, fl, scene, meta,
                         wall, nscene, nmeta, nmaps)
    # --- slices 13-16: the bitmap formats, decoded and rendered --------
    workdir = tempfile.mkdtemp(prefix='chip_smoke_item13_')
    try:
        it13 = item13_phases(torch, mnt, kern, sync, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # --- slice 16: the RNG's counters past 2^32 ------------------------
    rng_wide_check(torch)
    left = stop_cpu_halves()
    assert not left, f"{len(left)} CPU halves submitted and not taken"
    ad_launches = (pgrad['launches'] + pgrad['launches_recompute']
                   + hgrad['launches'] + hgrad['launches_recompute'])
    worst = max(worst, mat['max_abs_err'],
                opt['nlvrl_aniso_rays']['max_abs_err'],
                opt['long_vrl']['max_abs_err'], it7['max_abs_err'],
                it8['max_abs_err'], it10['max_abs_err'], it12['max_abs_err'])
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
                    + it10['launches_measured_polarized']
                    + it12['launches_dist_render']
                    + it12['launches_sharded_vrl_pass']
                    + it12['launches_dist_train_step']
                    + it13['launches_textured_formats']
                    + it13['launches_textured_large'])

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
            'measured_polarized_bound_by')},
        **{k: v for k, v in it12.items() if k not in ('max_abs_err',
                                                     'saturation_lanes')},
        **it13},
        {
        'name': 'intersect_tris_f64', 'route': 'cuda',
        'source': 'mitsuba_nlvrl_tpu_torch/csrc/intersect_f64.cu',
        'replaces': 'mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py:26',
        'launches': it10['launches_f64'],
        'max_abs_err': it10['max_abs_err_f64'],
        'ms': it10['f64_ms'], 'plain_ms': it10['f64_plain_ms'],
        'bound_ms': it10['f64_bound_ms'], 'bound_by': it10['f64_bound_by'],
        'library_ms': None,
        **{k: v for k, v in it10.items() if k.startswith(('f64_cbox_',
                                                          'f64_random_'))},
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

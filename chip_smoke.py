"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # about a minute on an H100

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, drives the port's main
path (``build_scene`` -> ``render`` of the 512x512 Cornell box, 16 spp,
``path`` with max_depth 8) through it, and checks the render against the
same scene rendered on the CPU. Each phase prints one JSON line; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero. Without a CUDA device it exits non-zero at once and
prints no result. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --- the card's published peaks (NVIDIA data sheets, dense) ----------------
# (memory bytes/s, fp32 FLOP/s outside the tensor cores)
_PEAKS = (('H200', 4.8e12, 67e12), ('H100 NVL', 3.9e12, 60e12),
          ('H100 PCIe', 2.0e12, 51e12), ('H100', 3.35e12, 67e12))

# arithmetic of one ray-triangle test in csrc/intersect.cu (products,
# sums and the division; the seven comparisons are not counted)
FLOPS_PER_PAIR = 46


def peaks(name: str):
    for key, bw, fl in _PEAKS:
        if key in name:
            return bw, fl
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
    cases = {
        'cbox_camera_512': (box, cam_rays),
        'random_1000': (random_tris(1000), random_rays(65536)),
        'random_5000': (random_tris(5000), random_rays(65536)),
        'ties_600': (ties, random_rays(65536)),
        'ragged_n': (random_tris(777), random_rays(100003)),
        'zero_tris': (empty, random_rays(4099)),
    }
    out, worst = {}, 0.0
    for name, (tris, rays) in cases.items():
        for any_hit in (False, True):
            got = kern.intersect_tris(*tris, *rays, any_hit=any_hit)
            ref = kern.intersect_tris_plain(*tris, *rays, any_hit=any_hit)
            torch.cuda.synchronize()
            occ_mismatch = int((torch.isfinite(got[0])
                                != torch.isfinite(ref[0])).sum())
            rec = {'occluded_mismatch': occ_mismatch}
            assert occ_mismatch == 0, (name, any_hit, rec)
            if not any_hit:
                hit = torch.isfinite(ref[0])
                idx_mismatch = int((got[1] != ref[1]).sum())
                err = max([float((a[hit] - b[hit]).abs().max())
                           if bool(hit.any()) else 0.0
                           for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                                        (got[3], ref[3]))])
                bits = sum(int((a.view(torch.int32)
                                != b.view(torch.int32)).sum())
                           for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                                        (got[3], ref[3])))
                rec.update(idx_mismatch=idx_mismatch, max_abs_err=err,
                           bit_mismatch=bits, hits=int(hit.sum()))
                worst = max(worst, err)
                assert idx_mismatch == 0 and bits == 0, (name, rec)
                if name == 'ties_600':
                    # duplicated triangles: the lower copy wins every tie
                    assert bool((got[1][hit] < 300).all()), rec
            out[f"{name}{'_any' if any_hit else ''}"] = rec
    return out, worst, box, cam_rays


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
    from mitsuba_nlvrl_tpu_torch.testing import compare
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box

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

    # --- kernel against its plain version on the card -------------------
    desc = cornell_box(spp=16, res=512,
                       integrator={'type': 'path', 'max_depth': 8})
    scene, meta = mnt.build_scene(desc)
    checks, worst, box, cam_rays = kernel_check(torch, kern, dev, scene,
                                                meta)
    emit({'phase': 'kernel_check', 'cases': checks, 'max_abs_err': worst})
    N, T = cam_rays[0].shape[0], box[0].shape[0]
    ms = time_ms(lambda: kern.intersect_tris(*box, *cam_rays), 7, 50)
    ms_any = time_ms(lambda: kern.intersect_tris(*box, *cam_rays,
                                                 any_hit=True), 7, 50)
    plain_ms = time_ms(lambda: kern.intersect_tris_plain(*box, *cam_rays),
                       5, 3)
    call_ms = host_ms(lambda: kern.intersect_tris(*box, *cam_rays), 200)
    bw, fl = peaks(name)
    nbytes = N * (12 + 12 + 4 + 4) + 3 * T * 12 + N * 16
    nops = FLOPS_PER_PAIR * N * T
    bound_bytes_ms, bound_ops_ms = nbytes / bw * 1e3, nops / fl * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    emit({'phase': 'kernel_time', 'rays': N, 'tris': T, 'ms': ms,
          'ms_any_hit': ms_any, 'plain_ms': plain_ms,
          'host_ms_per_call': call_ms, 'bytes': nbytes,
          'flops': nops, 'bound_ms': bound_ms,
          'bound_bytes_ms': bound_bytes_ms, 'bound_ops_ms': bound_ops_ms})

    # --- the main path: 512x512 Cornell box, 16 spp, path max_depth 8 ---
    mnt.render(scene, meta, seed=0, spp=1)            # warm-up pass
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
          'kernel_share_est': launches * 0.5 * (ms + ms_any) / 1e3 / wall,
          'finite': finite, 'mean': float(img_np.mean()),
          'shape': list(img_np.shape)})
    assert launches > 0, "the render launched no intersection kernel"
    assert finite and img_np.shape == (512, 512, 3), img_np.shape
    assert 0.01 < float(img_np.mean()) < 10.0, img_np.mean()

    # --- the card path against the CPU path, 64x64 at 4 spp -----------
    small = cornell_box(spp=4, res=64,
                        integrator={'type': 'path', 'max_depth': 8})
    sg, mg = mnt.build_scene(small)
    sc, mc = mnt.build_scene(small, device='cpu')
    img_g, _, rays_g = compare.render_with_passes(sg, mg, 0, 4)
    img_c, passes_c, rays_c = compare.render_with_passes(sc, mc, 0, 4)
    agree = compare.agreement(img_g, img_c, passes_c, rays_g, rays_c)
    emit({'phase': 'card_vs_cpu', **agree})
    compare.check(agree)

    emit({'kernels': [{
        'name': 'intersect_tris', 'route': 'cuda',
        'source': 'mitsuba_nlvrl_tpu_torch/csrc/intersect.cu',
        'replaces': 'mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py:26',
        'launches': launches, 'max_abs_err': worst, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': 'bytes' if bound_bytes_ms >= bound_ops_ms
        else 'operations',
        'library_ms': None}]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Where the PyTorch port's path-traced Cornell box spends its time on a GPU.

    python3 scripts/port_profile_render.py [--res 512] [--spp 16]

Runs on one CUDA device (it fails without one) and prints JSON lines:
  render     wall time and measured rays of a full render (after warm-up)
  bounces    host time of every bounce of one pass, synchronised
  parts      CUDA-event times of the pieces of one bounce at the pass's
             width (random draws, the intersection kernel, compute_si,
             emitter and BSDF sampling) and of one `active.any()` readback
  profile    torch.profiler over one pass: device busy time, the share of
             the intersection kernel, the idle share, the top kernels
The card's name and power limit (nvidia-smi) come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import mitsuba_nlvrl_tpu_torch as mnt  # noqa: E402
from mitsuba_nlvrl_tpu_torch import bsdf, emitter, sensor  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core import rng  # noqa: E402
from mitsuba_nlvrl_tpu_torch.integrators import path  # noqa: E402
from mitsuba_nlvrl_tpu_torch.integrators.common import \
    film_sample_positions  # noqa: E402
from mitsuba_nlvrl_tpu_torch.ops import intersect as isect  # noqa: E402
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def first_pass_state(scene, meta, dev):
    key = rng.fold_in(rng.PRNGKey(0), 0)
    pos_key, samp_key = rng.split(key)
    pos, pos01 = film_sample_positions(meta, pos_key, 0, dev)
    N = pos.shape[0]
    ray, _ = sensor.sample_ray(scene, meta, pos01, None)
    st = path.PathState(
        sampler=rng.Sampler.make(samp_key, N, dev), ray=ray,
        throughput=torch.ones((N, 3), device=dev),
        result=torch.zeros((N, 3), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_pdf=torch.ones((N,), device=dev),
        prev_delta=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_p=ray.o)
    return st, N


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--spp', type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({'card': smi, 'torch': torch.__version__})
    dev = torch.device('cuda')
    scene, meta = mnt.build_scene(cornell_box(
        spp=args.spp, res=args.res,
        integrator={'type': 'path', 'max_depth': 8}))
    mnt.render(scene, meta, seed=0, spp=1)            # build + warm-up

    stats = []
    t0 = time.time()
    mnt.render(scene, meta, seed=0, spp=args.spp, ray_stats=stats)
    wall = time.time() - t0
    rays = sum(float(r) for r in stats)
    emit({'phase': 'render', 'res': args.res, 'spp': args.spp,
          'wall_s': wall, 'rays': rays, 'mrays_per_s': rays / wall / 1e6,
          'ms_per_pass': wall / args.spp * 1e3})

    # --- host time of each bounce of pass 0 ----------------------------
    body_st, N = first_pass_state(scene, meta, dev)
    body = path.make_body(scene, meta, N)
    st, times, live = body_st, [], []
    torch.cuda.synchronize()
    while bool(st.active.any()):
        live.append(int(st.active.sum()))
        t0 = time.time()
        st = body(st)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    emit({'phase': 'bounces', 'lanes': N, 'ms': times, 'live_lanes': live})

    # --- the pieces of one bounce, CUDA events --------------------------
    st0 = body_st
    si = isect.ray_intersect(scene, st0.ray)
    key = rng.PRNGKey(3)
    u1 = torch.rand(N, device=dev)
    u2 = torch.rand(N, 2, device=dev)
    g = scene.geo
    r = st0.ray
    ray_args = (r.o.contiguous(), r.d.contiguous(), r.mint.contiguous(),
                r.maxt.contiguous())
    flag = torch.ones(N, dtype=torch.bool, device=dev)
    parts = {
        'uniform_1d': event_ms(lambda: rng.uniform(key, (N,), dev)),
        'uniform_2d': event_ms(lambda: rng.uniform(key, (N, 2), dev)),
        'kernel_nearest': event_ms(lambda: intersect_cuda.intersect_tris(
            g.v0, g.e1, g.e2, *ray_args)),
        'kernel_any': event_ms(lambda: intersect_cuda.intersect_tris(
            g.v0, g.e1, g.e2, *ray_args, any_hit=True)),
        'intersect_preliminary': event_ms(
            lambda: isect.intersect_preliminary(scene, r)),
        'ray_intersect': event_ms(lambda: isect.ray_intersect(scene, r)),
        'emitter_sample_direction': event_ms(
            lambda: emitter.sample_direction(scene, meta, si.p, u1, u2,
                                             flag)),
        'bsdf_sample': event_ms(
            lambda: bsdf.sample(scene, meta, si, u1, u2)),
        'bsdf_eval_pdf': event_ms(
            lambda: (bsdf.eval(scene, meta, si, si.wi),
                     bsdf.pdf(scene, meta, si, si.wi))),
        'bounce_body': event_ms(lambda: body(st0), reps=5),
    }
    t0 = time.time()
    for _ in range(100):
        bool(flag.any())
    parts['active_any_readback'] = (time.time() - t0) * 10.0
    emit({'phase': 'parts', 'lanes': N, 'ms': parts})

    # --- torch.profiler over one pass -----------------------------------
    from torch.profiler import ProfilerActivity, profile
    key0 = rng.fold_in(rng.PRNGKey(0), 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        mnt.render_pass(scene, meta, key0, 1)
        torch.cuda.synchronize()
        pass_ms = (time.time() - t0) * 1e3
    # kernels alone: the CPU-side operators also carry the device time of
    # the kernels they launched, which would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    mt = sum(e.self_device_time_total for e in kernels
             if 'mt_kernel' in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({'phase': 'profile', 'pass_ms_profiled': pass_ms,
          'device_busy_ms': busy, 'idle_share': 1.0 - busy / pass_ms,
          'intersect_kernel_ms': mt,
          'intersect_kernel_share_of_busy': mt / busy if busy else None,
          'kernel_launches': int(sum(e.count for e in kernels)),
          'top': [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                  for e in top]})
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Where the PyTorch port's volumetric render spends its time on a GPU.

    python3 scripts/port_profile_volpath.py [--width 768] [--height 576]
        [--grid 128] [--spp 2] [--device cuda|cpu]

Renders ``hetvol_box`` (the Cornell box around a heterogeneous medium,
sigma_t x100, HG phase, ``volpath`` with max_depth 8) on one CUDA device
(it fails without one) and prints JSON lines:
  render   wall time, rays, kernel launches and host syncs of two full
           renders after a warm-up pass
  walk     the medium's collision walk at the film's width on camera rays
           through the medium: CUDA-event time of one delta-tracking walk
           (``sample_real_interaction``) and one ratio-tracking walk
           (``segment_tr``), their trips, and the device time of one
           trip's random draw
  profile  torch.profiler over one pass: device busy time, the idle
           share of the profiled pass and of an unprofiled pass (the
           profiler slows the host), kernel launches, the top kernels
  counts   what one pass (spp 1) issues: the torch operations it
           dispatched and the share inside the walk, the walks and their
           trips, host syncs, kernel launches, rays, and the share of the
           grid's voxels whose supervoxel block is vacuum
The card's name and power limit (nvidia-smi) come first. With
``--device cpu`` only ``counts`` runs: the counts need no card, and on
the CPU they say nothing about time.
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
from mitsuba_nlvrl_tpu_torch import medium, sensor  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core import rng, sync  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core.ray import Ray  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core.rng import Sampler  # noqa: E402
from mitsuba_nlvrl_tpu_torch.integrators.common import \
    film_sample_positions  # noqa: E402
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing.walk_probe import \
    record_walks  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps=5):
    """Device time of one call (CUDA events, after one warm-up call), and
    the call's last result."""
    out = fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--width', type=int, default=768)
    ap.add_argument('--height', type=int, default=576)
    ap.add_argument('--grid', type=int, default=128)
    ap.add_argument('--spp', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    desc = hetvol_box(args.width, args.height, spp=args.spp,
                      grid_res=args.grid, seed=0, scale=100.0)
    if args.device == 'cpu':
        counts(*mnt.build_scene(desc, device='cpu'), args)
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({'card': smi, 'torch': torch.__version__})
    dev = torch.device('cuda')
    scene, meta = mnt.build_scene(desc)
    mnt.render(scene, meta, seed=0, spp=1)            # build + warm-up

    for k in range(2):
        stats = []
        sync.host_syncs, intersect_cuda.launches = 0, 0
        torch.cuda.synchronize()
        t0 = time.time()
        mnt.render(scene, meta, seed=k, spp=args.spp, ray_stats=stats)
        wall = time.time() - t0
        pass_ms_unprofiled = wall / args.spp * 1e3
        rays = sum(float(r) for r in stats)
        emit({'phase': 'render', 'seed': k, 'spp': args.spp, 'wall_s': wall,
              'rays': rays, 'mrays_per_s': rays / wall / 1e6,
              'launches': intersect_cuda.launches,
              'host_syncs': sync.host_syncs})

    # --- the walk at the film's width, on camera rays through the medium
    N = args.width * args.height
    key = rng.fold_in(rng.PRNGKey(0), 0)
    pos_key, _ = rng.split(key)
    _, pos01 = film_sample_positions(meta, pos_key, 0, dev)
    cam, _ = sensor.sample_ray(scene, meta, pos01, None)
    ray = Ray(cam.o.contiguous(), cam.d.contiguous(), cam.mint.contiguous(),
              torch.full((N,), 10.0, device=dev))
    midx = torch.zeros((N,), dtype=torch.int32, device=dev)
    channel = torch.zeros((N,), dtype=torch.int32, device=dev)
    act = torch.ones((N,), dtype=torch.bool, device=dev)
    smp = Sampler.make(rng.PRNGKey(5), N, dev)
    with record_walks() as log:
        delta_ms, (mi, _, _) = event_ms(
            lambda: medium.sample_real_interaction(scene, meta, ray, smp,
                                                   channel, midx, act))
    trips = {'delta': log.walks[-1]['trips']}
    with record_walks() as log:
        ratio_ms, _ = event_ms(lambda: medium.segment_tr(
            scene, meta, smp, ray.o, ray.d, ray.maxt, midx, channel, act))
    trips['ratio'] = log.walks[-1]['trips']
    draw_ms, _ = event_ms(lambda: rng.uniform(
        key, (medium.WALK_UNROLL, N, 3), dev), reps=20)
    emit({'phase': 'walk', 'lanes': N,
          'real_collisions': int(mi.valid.sum()),
          'delta_tracking_ms': delta_ms, 'delta_trips': trips['delta'],
          'ratio_tracking_ms': ratio_ms, 'ratio_trips': trips['ratio'],
          'ms_per_trip_delta': delta_ms / max(trips['delta'], 1),
          'ms_per_trip_ratio': ratio_ms / max(trips['ratio'], 1),
          'draw_ms_per_trip': draw_ms})

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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({'phase': 'profile', 'pass_ms_profiled': pass_ms,
          'device_busy_ms': busy, 'idle_share': 1.0 - busy / pass_ms,
          'pass_ms_unprofiled': pass_ms_unprofiled,
          'idle_share_unprofiled': 1.0 - busy / pass_ms_unprofiled,
          'intersect_kernel_ms': mt,
          'intersect_kernel_share_of_busy': mt / busy if busy else None,
          'kernel_launches': int(sum(e.count for e in kernels)),
          'top': [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                  for e in top]})
    counts(scene, meta, args)
    return 0


def counts(scene, meta, args):
    """The ``counts`` phase: one pass (spp 1) under an operation
    counter, with every walk recorded."""
    sync.host_syncs, intersect_cuda.launches, stats = 0, 0, []
    with record_walks(count_ops=True) as log:
        mnt.render(scene, meta, seed=0, spp=1, ray_stats=stats)
    lanes = args.width * args.height
    emit({'phase': 'counts', 'device': str(scene.device), 'lanes': lanes,
          'ops': log.ops,
          'walk_ops_share': sum(w['ops'] for w in log.walks) / log.ops,
          'walks': len(log.walks), 'trips': log.trips(),
          'trips_delta_tracking': log.trips(track=True),
          'trips_ratio_tracking': log.trips(track=False),
          'max_trips_a_walk': max(w['trips'] for w in log.walks),
          'host_syncs': sync.host_syncs,
          'vacuum_block_share': float(
              (scene.media.grid_sigma_p8[:, 9] < 0).float().mean()),
          'launches': intersect_cuda.launches, 'rays': float(stats[0]),
          'rays_a_lane': float(stats[0]) / lanes})


if __name__ == '__main__':
    sys.exit(main())

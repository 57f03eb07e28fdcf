"""Where the PyTorch port's NLVRL render spends its time on a GPU.

    python3 scripts/port_profile_nlvrl.py [--width 512] [--height 256]
        [--spp 2] [--target-vrls 8000] [--integrator vrl|photonmapper]
        [--device cuda|cpu]

Renders ``cbox_nlvrl`` (the Cornell box around a nonlinear medium with a
640-cell IOR grid, lit by a laser; ``vrl`` with cluster VRL selection) and
prints JSON lines:
  render  on the card: the wall time of a full render (preprocess and
          camera passes apart, after a warm-up render), rays, kernel
          launches, host syncs, the map statistics, and each part's
          device time (``testing/nlvrl_probe.py``: the light pass, the
          map and cluster builds, and the camera pass's bend march,
          volume gather, VRL query and surface gathers) with its share
          of the camera passes
  counts  what one render (spp 1) dispatches: the torch operations of each
          part and of the whole, host syncs, intersection calls by kind
          and rays; the counts need no card, and on the CPU they say
          nothing about time
The card's name and power limit (nvidia-smi) come first. With
``--device cpu`` only ``counts`` runs.
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
from mitsuba_nlvrl_tpu_torch.core import sync  # noqa: E402
from mitsuba_nlvrl_tpu_torch.integrators import lighttrace  # noqa: E402
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect  # noqa: E402
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing.nlvrl_probe import (  # noqa: E402
    CAMERA_PARTS, PARTS, record_parts)
from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def render_phase(scene, meta, args):
    mnt.render(scene, meta, seed=0, spp=1)          # warm-up
    torch.cuda.synchronize()
    intersect_cuda.launches = 0
    sync.host_syncs = 0
    stats, info = [], {}
    with record_parts(timed=True) as log:
        img = mnt.render(scene, meta, seed=0, spp=args.spp, ray_stats=stats,
                         info=info)
        torch.cuda.synchronize()
    launches, syncs = intersect_cuda.launches, sync.host_syncs
    rays = sum(float(r) for r in stats)
    camera_s = info['wall_s'] - info['preprocess_s']
    parts = {name: {'calls': log.calls(name),
                    'device_s': log.device_s(name),
                    'host_s': log.host_s(name)} for name in PARTS}
    for name in CAMERA_PARTS:
        parts[name]['share_of_camera'] = parts[name]['device_s'] / camera_s
    aux = mnt.preprocess(scene, meta, 0)
    emit({'phase': 'render', 'res': [args.width, args.height],
          'spp': args.spp, 'integrator': args.integrator,
          'wall_s': info['wall_s'], 'preprocess_s': info['preprocess_s'],
          'camera_s': camera_s, 'rays': rays,
          'mrays_per_s': rays / info['wall_s'] / 1e6,
          'launches': launches, 'host_syncs': syncs, 'parts': parts,
          'maps': lighttrace.map_stats(aux),
          'mean': float(img.mean()), 'finite': bool(img.isfinite().all())})


def counts(scene, meta, args):
    calls = {'nearest': 0, 'any_hit': 0}
    real = pisect.intersect_tris

    def counting(*a, any_hit=False):
        calls['any_hit' if any_hit else 'nearest'] += 1
        return real(*a, any_hit=any_hit)
    pisect.intersect_tris = counting
    sync.host_syncs = 0
    stats = []
    try:
        with record_parts(count_ops=True) as log:
            mnt.render(scene, meta, seed=0, spp=1, ray_stats=stats)
    finally:
        pisect.intersect_tris = real
    emit({'phase': 'counts', 'res': [args.width, args.height], 'spp': 1,
          'integrator': args.integrator, 'ops': log.total_ops,
          'part_ops': {n: log.ops(n) for n in PARTS},
          'part_calls': {n: log.calls(n) for n in PARTS},
          'host_syncs': sync.host_syncs, 'intersect_calls': calls,
          'rays': sum(float(r) for r in stats)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--width', type=int, default=512)
    ap.add_argument('--height', type=int, default=256)
    ap.add_argument('--spp', type=int, default=2)
    ap.add_argument('--target-vrls', type=int, default=8000)
    ap.add_argument('--integrator', choices=('vrl', 'photonmapper'),
                    default='vrl')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            print("port_profile_nlvrl: no CUDA device", file=sys.stderr)
            return 1
        emit({'phase': 'device', 'nvidia_smi': subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip()})
        intersect_cuda.build()
    t0 = time.time()
    scene, meta = mnt.build_scene(
        cbox_nlvrl(args.width, args.height, spp=args.spp,
                   target_vrls=args.target_vrls,
                   integrator=args.integrator), device=args.device)
    emit({'phase': 'build', 'seconds': time.time() - t0})
    if args.device == 'cuda':
        render_phase(scene, meta, args)
    counts(scene, meta, args)
    return 0


if __name__ == '__main__':
    sys.exit(main())

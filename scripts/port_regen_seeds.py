"""The regeneration scheduler against the pass loop over seeds, in the
PyTorch port.

    python3 scripts/port_regen_seeds.py [--res 24] [--spp 4] [--seeds 16]
        [--scale 5] [--grid 16] [--lanes 16384] [--device cpu|cuda]

Renders ``hetvol_box`` (a ``res`` x ``res`` film, a ``grid``^3 density
grid at sigma_t x ``scale``, ``volpath`` max_depth 8) from seeds 0 to
``seeds - 1`` through the pass loop (``MNT_REGEN=0``), the regeneration
scheduler (``MNT_REGEN=1``, ``lanes`` lanes) and the regeneration
scheduler with its film jitter salted by the seed (the pass index given
to ``sampler.lane_jitter`` plus 4,096 times the seed, so that each seed
samples its own film positions). Prints one JSON line a scheduler (the
mean image value, its standard error over seeds, the seconds) and one
line a comparison with the pass loop (the gap, relative gap, standard
error and z). Without ``--device`` it renders on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mitsuba_nlvrl_tpu_torch as mnt  # noqa: E402
from mitsuba_nlvrl_tpu_torch.integrators import regen  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--res', type=int, default=24)
    ap.add_argument('--spp', type=int, default=4)
    ap.add_argument('--seeds', type=int, default=16)
    ap.add_argument('--scale', type=float, default=5.0)
    ap.add_argument('--grid', type=int, default=16)
    ap.add_argument('--lanes', type=int, default=16384)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    if a.device == 'cpu':
        torch.set_num_threads(min(4, torch.get_num_threads()))
    scene, meta = mnt.build_scene(
        hetvol_box(a.res, a.res, spp=a.spp, grid_res=a.grid, seed=0,
                   scale=a.scale), device=a.device)
    os.environ['MNT_REGEN_LANES'] = str(a.lanes)
    real = regen.lane_jitter
    salt = [0]
    means = {}
    for name, mode, salted in (('pass_loop', '0', False),
                               ('regen', '1', False),
                               ('regen_salted', '1', True)):
        os.environ['MNT_REGEN'] = mode
        regen.lane_jitter = (
            (lambda t, pss, pix: real(t, pss + 4096 * salt[0], pix))
            if salted else real)
        t0, m = time.time(), []
        for s in range(a.seeds):
            salt[0] = s
            m.append(float(mnt.render(scene, meta, seed=s,
                                      spp=a.spp).mean()))
        regen.lane_jitter = real
        means[name] = np.array(m)
        print(json.dumps({'scheduler': name, 'mean': means[name].mean(),
                          'se': means[name].std(ddof=1) / np.sqrt(a.seeds),
                          'seconds': time.time() - t0}), flush=True)
    base = means['pass_loop']
    for name in ('regen', 'regen_salted'):
        gap = means[name].mean() - base.mean()
        se = np.sqrt(base.var(ddof=1) / a.seeds
                     + means[name].var(ddof=1) / a.seeds)
        print(json.dumps({'compare': name, 'gap': gap,
                          'rel': gap / base.mean(), 'se': se,
                          'z': gap / se}))
    print(json.dumps({'res': a.res, 'spp': a.spp, 'seeds': a.seeds,
                      'scale': a.scale, 'grid': a.grid, 'lanes': a.lanes,
                      'device': a.device}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Run ``chip_smoke.py`` of several checkouts one after the other on one
host, to compare their clocks where the host's speed is the same.

    python3 scripts/port_smoke_pair.py DIR [DIR ...] [--timeout 1500]

Each DIR is a checkout (for example ``git archive`` of a commit unpacked
under ``.compare/``, which ``.gitignore`` lists). The script prints the
card's name and power limit, the host's CPU count and the torch and CUDA
versions, then for each DIR the exit code and wall seconds of its
``chip_smoke.py`` and the last lines of its output; each run's output and
errors go to ``chiprun_out/<name of DIR>.log`` and ``.err``. Each phase
line of a run carries ``elapsed_s``, the seconds since its start.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('dirs', nargs='+')
    ap.add_argument('--timeout', type=float, default=1500.0)
    args = ap.parse_args()
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print('cpus', os.cpu_count(), len(os.sched_getaffinity(0)),
          subprocess.run([sys.executable, '-c',
                          'import torch; print(torch.__version__, '
                          'torch.version.cuda)'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc_all = 0
    for d in args.dirs:
        name = os.path.basename(os.path.normpath(d))
        log = os.path.join(out_dir, f'{name}.log')
        err = os.path.join(out_dir, f'{name}.err')
        t0 = time.time()
        with open(log, 'w') as fo, open(err, 'w') as fe:
            try:
                rc = subprocess.run([sys.executable, 'chip_smoke.py'],
                                    cwd=d, stdout=fo, stderr=fe,
                                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        wall = time.time() - t0
        rc_all = rc_all or rc
        print(f'{name} rc={rc} wall={wall:.1f}', flush=True)
        with open(log) as f:
            for line in f.read().splitlines()[-2:]:
                print('  ' + line[:300])
        with open(err) as f:
            for line in f.read().splitlines()[-3:]:
                print('  ' + line[:300])
    return rc_all


if __name__ == '__main__':
    sys.exit(main())

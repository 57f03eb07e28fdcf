"""Start the ranks of a multi-rank port test and collect their outputs.

Each rank is a process of its own (``tests/torch_dist_worker.py``, started
fresh, never forked from the test process): gloo on the CPU, joined
through a ``file://`` store under the test's ``tmp_path`` (or, for
``init_env``, through a free port the system picks), one torch thread a
rank, ``PYTHONPATH`` dropped. Inputs and outputs go through ``.npz``
files. The ranks share one deadline: a rank that fails ends the others at
once, and a collective mismatch that hangs them fails the test at the
deadline instead of hanging the suite.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
RANK_TIMEOUT = 120.0


def pack(scene_arrays: dict, meta_dict: dict, maps_arrays=None, **extra):
    """The ``.npz`` inputs of a job: the scene's arrays, its meta (a
    pickled dict of ``scene_from_numpy``'s form), the maps' arrays and
    any other arrays."""
    d = {f'scene.{k}': v for k, v in scene_arrays.items()}
    d['meta'] = np.frombuffer(pickle.dumps(meta_dict), np.uint8)
    for k, v in (maps_arrays or {}).items():
        d[f'maps.{k}'] = v
    d.update({k: np.asarray(v) for k, v in extra.items()})
    return d


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def start_ranks(tmp_path, job: str, world: int, inputs: dict,
                from_env: bool = False):
    """Start ``world`` ranks of ``job``; returns the handle that
    ``wait_ranks`` takes."""
    d = tmp_path / f'{job}_{world}'
    d.mkdir()
    path_in = str(d / 'in.npz')
    np.savez(path_in, **inputs)
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    if from_env:
        env.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world))
    procs, outs, logs = [], [], []
    for r in range(world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if from_env else env
        outs.append(str(d / f'out{r}.npz'))
        logs.append(open(d / f'log{r}.txt', 'w+'))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, job, str(r), str(world),
             str(d / 'store'), path_in, outs[r]], cwd=ROOT, env=e,
            stdout=logs[r], stderr=subprocess.STDOUT))
    return job, procs, outs, logs, time.time() + RANK_TIMEOUT


def wait_ranks(handle) -> list:
    """Each rank's outputs (dicts of arrays), in rank order; fails on a
    rank's error or at the deadline, ending every rank."""
    job, procs, outs, logs, deadline = handle
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} of {job}: exit {p.returncode} (deadline "
            f"{RANK_TIMEOUT:g} s)\n" + texts[r][-3000:])
    out = []
    for o in outs:
        with np.load(o) as f:
            out.append(dict(f))
    return out


def unpickle(a):
    return pickle.loads(np.asarray(a).tobytes())

"""Instruments the medium's collision walk for the measurement scripts
(``chip_smoke.py``, ``scripts/port_profile_volpath.py``).

    with record_walks(timed=True) as log:
        render(...)
    torch.cuda.synchronize()
    log.trips(), log.device_s(), log.host_s()

Inside the block every call of ``medium._majorant_walk`` is recorded:
its mode (``track``: delta tracking, else ratio tracking) and its trips
(``WALK_UNROLL`` events each); with ``timed``, CUDA events around it
(device timeline) and the host clock; with ``count_ops``, the torch
operations it dispatched (views count too), and ``log.ops`` those of the
whole block.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import medium


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class WalkLog:
    def __init__(self):
        self.walks = []     # a dict a walk: track, trips (, events, ...)
        self.ops = 0

    def trips(self, track=None) -> int:
        return sum(w['trips'] for w in self.walks
                   if track is None or w['track'] == track)

    def device_s(self) -> float:
        """Device time of the walks (``timed``; after a synchronise)."""
        return sum(a.elapsed_time(b) for a, b in
                   (w['events'] for w in self.walks)) / 1e3

    def host_s(self) -> float:
        return sum(w['host_s'] for w in self.walks)


@contextlib.contextmanager
def record_walks(timed: bool = False, count_ops: bool = False):
    real = medium._majorant_walk
    log = WalkLog()
    counter = _OpCount() if count_ops else None

    def walk(*args, **kw):
        rec = {'track': kw['track']}
        n0 = counter.n if counter else 0
        if timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
        out = real(*args, **kw)
        if timed:
            b.record()
            rec.update(events=(a, b), host_s=time.perf_counter() - t0)
        if counter:
            rec['ops'] = counter.n - n0
        rec['trips'] = out[-1] // medium.WALK_UNROLL
        log.walks.append(rec)
        return out

    medium._majorant_walk = walk
    try:
        with counter if counter else contextlib.nullcontext():
            yield log
    finally:
        medium._majorant_walk = real
        log.ops = counter.n if counter else 0

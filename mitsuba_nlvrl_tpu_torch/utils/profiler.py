"""Profiling and counters.

Port of ``mitsuba_nlvrl_tpu/utils/profiler.py``:

  * ``trace(log_dir)``: a context manager around ``torch.profiler`` (CPU
    and, where there is a card, CUDA activities) that writes a Chrome
    trace of the block into ``log_dir`` and hands back the profiler, whose
    ``key_averages()`` sum the time by operation and kernel.
  * ``Timer``: a wall timer that first waits for the card's queued work
    (a CUDA launch returns before the device finishes).
  * ``Counters``: named render statistics accumulated as tensors or
    numbers and read on the host only at ``report()``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = 'mnt_trace'):
    """Profile the block; its Chrome trace goes to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """A wall timer whose readings wait for the card's queued work."""

    def __init__(self):
        self.reset()

    def reset(self):
        _sync()
        self._t0 = time.perf_counter()

    def value(self) -> float:
        _sync()
        return time.perf_counter() - self._t0

    def time_string(self) -> str:
        v = self.value()
        if v < 1:
            return f"{v * 1e3:.1f}ms"
        if v < 60:
            return f"{v:.2f}s"
        return f"{v / 60:.1f}m"


class Counters:
    """Named statistic accumulators; values may be tensors on the card,
    read only at ``report()``."""

    def __init__(self):
        self._acc: Dict[str, list] = {}

    def add(self, name: str, value):
        self._acc.setdefault(name, []).append(value)

    def report(self) -> Dict[str, float]:
        return {k: float(sum(float(v) for v in vs))
                for k, vs in self._acc.items()}

    def log(self, printer=print):
        for k, v in sorted(self.report().items()):
            printer(f"  [counter] {k}: {v:g}")

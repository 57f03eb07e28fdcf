"""Instruments the parts of the two-pass integrators for the measurement
scripts (``chip_smoke.py``, ``scripts/port_profile_nlvrl.py``).

    with record_parts(timed=True) as log:
        render(...)
    torch.cuda.synchronize()
    log.device_s('bend'), log.calls('vrl_query'), log.ops('volume_gather')

Inside the block every call of a part is recorded:
  shoot           ``lighttrace.shoot``, the light pass
  build_maps      ``lighttrace.build_maps``, the hash grids
  clusters        ``vrl.build_vrl_clusters``
  bend            ``nonlinear.bend_ray``, the camera pass's bend march
  volume_gather   ``vrl._gather_volume``, the volume-photon gather
  beam            ``vrl._beam_segments``, the beam radiance estimate
                  (``use_bre``) that takes the gather's place
  vrl_query       ``vrl._query_segments``, the VRL query of the segments
  surface_gather  ``photon_est.estimate_surface``, the surface gathers
with ``timed``, CUDA events around it (device timeline) and the host
clock; with ``count_ops``, the torch operations it dispatched (views
count too), and ``log.total_ops`` those of the whole block.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..integrators import lighttrace, photon_est, vrl
from ..medium import nonlinear
from .walk_probe import _OpCount

PARTS = {
    'shoot': (lighttrace, 'shoot'),
    'build_maps': (lighttrace, 'build_maps'),
    'clusters': (vrl, 'build_vrl_clusters'),
    'bend': (nonlinear, 'bend_ray'),
    'volume_gather': (vrl, '_gather_volume'),
    'beam': (vrl, '_beam_segments'),
    'vrl_query': (vrl, '_query_segments'),
    'surface_gather': (photon_est, 'estimate_surface'),
}
# the parts of the camera pass
CAMERA_PARTS = ('bend', 'volume_gather', 'beam', 'vrl_query',
                'surface_gather')


class PartLog:
    def __init__(self):
        self.records = {name: [] for name in PARTS}
        self.total_ops = 0

    def calls(self, name) -> int:
        return len(self.records[name])

    def device_s(self, name) -> float:
        """Device time of the part's calls (``timed``; after a
        synchronise). Calls nest in no other part, so the times add."""
        return sum(a.elapsed_time(b) for a, b in
                   (r['events'] for r in self.records[name])) / 1e3

    def host_s(self, name) -> float:
        return sum(r['host_s'] for r in self.records[name])

    def ops(self, name) -> int:
        return sum(r.get('ops', 0) for r in self.records[name])


@contextlib.contextmanager
def record_parts(timed: bool = False, count_ops: bool = False):
    log = PartLog()
    counter = _OpCount() if count_ops else None
    real = {name: getattr(mod, attr) for name, (mod, attr) in PARTS.items()}

    def wrap(name):
        fn = real[name]

        def part(*args, **kw):
            rec = {}
            n0 = counter.n if counter else 0
            t0 = time.perf_counter()
            if timed:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            out = fn(*args, **kw)
            if timed:
                b.record()
                rec['events'] = (a, b)
            rec['host_s'] = time.perf_counter() - t0
            if counter:
                rec['ops'] = counter.n - n0
            log.records[name].append(rec)
            return out
        return part

    for name, (mod, attr) in PARTS.items():
        setattr(mod, attr, wrap(name))
    try:
        with counter if counter else contextlib.nullcontext():
            yield log
    finally:
        for name, (mod, attr) in PARTS.items():
            setattr(mod, attr, real[name])
        log.total_ops = counter.n if counter else 0

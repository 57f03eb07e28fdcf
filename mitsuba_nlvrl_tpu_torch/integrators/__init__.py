"""Integrator registry.

Port of ``mitsuba_nlvrl_tpu/integrators/__init__.py``: each integrator
exposes ``sample(scene, meta, sampler, ray)`` over a ray wavefront. This
slice has ``path``, ``volpath`` and ``volpathmis`` (one estimator; the
latter adds MIS at medium vertices); the others raise, naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

from . import path as _path
from . import volpath as _volpath
from ..scene.types import not_in_slice

_REGISTRY = {'path': _path.sample, 'volpath': _volpath.sample,
             'volpathmis': _volpath.sample}


def get_integrator(name: str):
    if name not in _REGISTRY:
        raise not_in_slice(f"integrator '{name}'",
                           "items 7-11 (integrators)")
    return _REGISTRY[name]

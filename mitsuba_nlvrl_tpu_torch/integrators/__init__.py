"""Integrator registry.

Port of ``mitsuba_nlvrl_tpu/integrators/__init__.py``: each integrator
exposes ``sample(scene, meta, sampler, ray, active=None, diff=False,
aux=None)`` over a ray wavefront (``active`` the lanes to trace, all by
default; ``diff`` the differentiable bounce loops); the two-pass integrators (``vrl``, ``photonmapper`` and its
older name ``photonmap``) also expose ``preprocess(scene, meta, key) ->
aux``, their photon and VRL maps, which every pass reads. The port has
``path`` (with its spectral variant, ``path_spectral``), ``direct``,
``depth``, ``volpath``, ``volpathmis`` (one estimator; the latter adds
MIS at medium vertices), ``vrl``, ``photonmapper`` and the wrappers
``aov``, ``moment`` and ``stokes`` (whose polarized paths are
``path_polarized`` and ``path_spectral_polarized``).
"""
from __future__ import annotations

from . import aov as _aov
from . import depth as _depth
from . import direct as _direct
from . import path as _path
from . import photonmapper as _pm
from . import volpath as _volpath
from . import vrl as _vrl

_REGISTRY = {'path': _path.sample, 'direct': _direct.sample,
             'depth': _depth.sample, 'volpath': _volpath.sample,
             'volpathmis': _volpath.sample, 'vrl': _vrl.sample,
             'photonmapper': _pm.sample, 'photonmap': _pm.sample,
             'aov': _aov.sample_aov, 'moment': _aov.sample_moment,
             'stokes': _aov.sample_stokes}
_PREPROCESS = {'vrl': _vrl.preprocess, 'photonmapper': _pm.preprocess,
               'photonmap': _pm.preprocess}


def get_integrator(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown integrator '{name}'")
    return _REGISTRY[name]


def get_preprocess(name: str):
    """The integrator's preprocess, or None."""
    get_integrator(name)
    return _PREPROCESS.get(name)

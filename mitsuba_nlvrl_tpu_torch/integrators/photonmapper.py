"""Photon mapping integrator (surface and volume photon maps).

Port of ``mitsuba_nlvrl_tpu/integrators/photonmapper.py``: the two-pass
structure of the VRL integrator, with all volume transport from volume
photons (deposited at every medium scatter) gathered at points along the
(possibly bent) camera ray, and no VRLs.
"""
from __future__ import annotations

from . import vrl as vrl_mod


def preprocess(scene, meta, key):
    return vrl_mod.preprocess(scene, meta, key, vp_all_scatters=True)


sample = vrl_mod.make_sample(use_vrls=False)

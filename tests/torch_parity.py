"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

They carry a reference (JAX) scene into the port as numpy arrays, so both
packages render the very same arrays, and hold images against each other
with the golden suite's per-pixel z-test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from test_golden_suite import _z_test

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P


def scene_arrays(scene) -> dict:
    """Flatten a SceneData of either package into {dotted field path:
    ndarray}, the form ``scene_from_numpy`` takes. The port's occluder
    subset is left out: ``scene_from_numpy`` derives it from the other
    arrays (tests/test_torch_medium.py checks it)."""
    out = {}

    def walk(prefix, node):
        if node is None or prefix == 'occluders':
            return
        if hasattr(node, '_fields'):
            for f in node._fields:
                walk(f'{prefix}.{f}' if prefix else f, getattr(node, f))
        elif hasattr(node, 'shape'):
            out[prefix] = np.asarray(node)
    walk('', scene)
    return out


def jax_meta_dict(meta) -> dict:
    return dataclasses.asdict(meta)


def build_both(desc):
    """(reference scene, reference meta, port scene, port meta), the port's
    built from the reference's own arrays on the CPU."""
    sj, mj = J.build_scene(desc)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    return sj, mj, sp, mp


def z_test_pass_fraction(mean, spp, ref, ref_var, ref_spp, alpha=0.01):
    """Fraction of pixels whose two-sided p-value clears the Sidak
    threshold of the golden suite (tests/test_golden_suite.py::_gate)."""
    p = _z_test(mean, spp, ref, ref_var, ref_spp)
    alpha_c = 1.0 - (1.0 - alpha) ** (1.0 / p.size)
    return float((p >= alpha_c).mean())

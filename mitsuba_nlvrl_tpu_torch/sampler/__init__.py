"""Film-position sample generators.

Port of ``mitsuba_nlvrl_tpu/sampler/__init__.py`` for the ``independent``
sampler: the bounce-loop dimensions come from the counter-based stream of
``core/rng.py``, and the film jitter of each pass is one uniform draw.
"""
from __future__ import annotations

from ..core import rng
from ..scene.types import SLICE_SAMPLERS, not_in_slice


def film_jitter(sampler_type: str, key, pass_idx: int, spp: int, N: int,
                device=None):
    """Per-pixel 2D sample offset for this pass (pixel index = lane)."""
    if sampler_type not in SLICE_SAMPLERS and spp > 1:
        raise not_in_slice(f"sampler '{sampler_type}'", "item 3 (sampling)")
    return rng.uniform(key, (N, 2), device)

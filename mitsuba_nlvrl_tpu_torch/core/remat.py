"""Checkpointed functions for the differentiable render.

The reference's diff mode wraps each bounce and each walk trip in
``jax.checkpoint``: reverse mode keeps only a trip's inputs and recomputes
the trip during the backward pass. ``checkpoint`` is its counterpart,
``torch.utils.checkpoint.checkpoint`` without reentry. The port's random
numbers are counter based, so the recompute draws the same numbers
without torch's RNG state being saved; its host reads see the same values
and take the same branches. While a function is recomputed,
``core/counters.recomputing`` is True, so its kernel launches and host
reads count apart from the forward pass's.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from . import counters


def checkpoint(fn, *args):
    """``fn(*args)``, its intermediates freed after the forward pass and
    recomputed when autograd needs them. Without autograd (under
    ``torch.no_grad()``) it is the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        before = counters.recomputing
        counters.recomputing = True
        try:
            return fn(*a)
        finally:
            counters.recomputing = before

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)

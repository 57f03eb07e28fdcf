"""Device-to-host reads that end the wavefront loops.

The reference's ``lax.while_loop`` conditions (``any(active)``) become host
loops in the port, each trip reading one boolean back from the device.
``any_on_host`` is that read, ``int_on_host`` the read of a loop's trip
count; ``host_syncs`` counts both, so a run can show how many times the
host waited for the card. Reads made while autograd recomputes a
checkpointed function (``core/counters.recomputing``) count into
``host_syncs_recompute`` instead.
"""
from __future__ import annotations

import torch

from . import counters

# reads since the last reset (chip_smoke.py sets them to 0 and reads them)
host_syncs = 0
host_syncs_recompute = 0


def _count() -> None:
    global host_syncs, host_syncs_recompute
    if counters.recomputing:
        host_syncs_recompute += 1
    else:
        host_syncs += 1


def any_on_host(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted."""
    _count()
    return bool(mask.any())


def int_on_host(x: torch.Tensor) -> int:
    """``int(x)`` of a 0-d tensor, counted."""
    _count()
    return int(x)


def nonzero_on_host(mask: torch.Tensor) -> torch.Tensor:
    """``mask.nonzero()[:, 0]`` of a 1-d mask (its size is a host read),
    counted."""
    _count()
    return mask.nonzero()[:, 0]

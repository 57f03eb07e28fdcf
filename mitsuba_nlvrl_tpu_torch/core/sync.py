"""Device-to-host reads that end the wavefront loops.

The reference's ``lax.while_loop`` conditions (``any(active)``) become host
loops in the port, each trip reading one boolean back from the device.
``any_on_host`` is that read, ``int_on_host`` the read of a loop's trip
count; ``host_syncs`` counts both, so a run can show how many times the
host waited for the card.
"""
from __future__ import annotations

import torch

# reads since the last reset (chip_smoke.py sets it to 0 and reads it)
host_syncs = 0


def any_on_host(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any())


def int_on_host(x: torch.Tensor) -> int:
    """``int(x)`` of a 0-d tensor, counted."""
    global host_syncs
    host_syncs += 1
    return int(x)


def nonzero_on_host(mask: torch.Tensor) -> torch.Tensor:
    """``mask.nonzero()[:, 0]`` of a 1-d mask (its size is a host read),
    counted."""
    global host_syncs
    host_syncs += 1
    return mask.nonzero()[:, 0]

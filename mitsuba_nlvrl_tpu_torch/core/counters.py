"""The render's counters in one place: launches of the ray-triangle
kernels (``ops/cuda/intersect_cuda.launches``, and ``launches_f64`` of the
double variant's), BVH traversals, their steps
and the lanes cut at the step cap (``ops/bvh.stats``), and host reads
(``core/sync.host_syncs``). ``reset`` sets all to 0 and ``read`` returns
them, so a caller brackets a render with the two.

A differentiable render recomputes each checkpointed bounce and walk trip
during the backward pass (``core/remat.py``). While it does,
``recomputing`` is True, and the kernel's wrapper and the host reads count
into ``launches_recompute`` and ``host_syncs_recompute`` instead: the
forward counts stay those of one forward pass."""
from __future__ import annotations

# True while autograd recomputes a checkpointed function
recomputing = False


def reset() -> None:
    from . import sync
    from ..ops import bvh
    from ..ops.cuda import intersect_cuda
    intersect_cuda.launches = 0
    intersect_cuda.launches_recompute = 0
    intersect_cuda.launches_f64 = 0
    intersect_cuda.launches_f64_recompute = 0
    bvh.reset_stats()
    sync.host_syncs = 0
    sync.host_syncs_recompute = 0


def read() -> dict:
    from . import sync
    from ..ops import bvh
    from ..ops.cuda import intersect_cuda
    return {'kernel_launches': intersect_cuda.launches,
            'bvh_calls': bvh.stats['calls'], 'bvh_steps': bvh.stats['steps'],
            'bvh_max_steps': bvh.stats['max_steps'],
            'bvh_lanes_cut': bvh.stats['lanes_cut'],
            'host_syncs': sync.host_syncs,
            'kernel_launches_recompute': intersect_cuda.launches_recompute,
            'kernel_launches_f64': intersect_cuda.launches_f64,
            'kernel_launches_f64_recompute':
                intersect_cuda.launches_f64_recompute,
            'host_syncs_recompute': sync.host_syncs_recompute}

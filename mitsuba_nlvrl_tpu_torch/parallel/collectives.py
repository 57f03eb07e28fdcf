"""The port's collectives over ``torch.distributed``.

A mesh axis is named by a string ("dp", "mp"), as in the reference's
``jax.sharding`` code. ``axis_group`` turns a mesh and an axis name into
the process group, this process's rank in it and its size. ``bind``
binds axis names to groups for the duration of a call, which is how the
VRL integrator's map all-reduce (``integrators/vrl._map_psum``) finds
the group of its ``map_psum_axis``; outside such a call the name is
unbound and the all-reduce raises, as the reference's ``psum`` does
outside ``shard_map``.

The backend follows the tensors' device and never switches on its own:
NCCL for CUDA tensors, gloo for CPU tensors. ``all_reduces`` counts the
sums made since the last reset; under ``timed()`` each one is bracketed
by CUDA events on the card, and ``elapsed_s`` adds their times up.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

# sums over a group since the last reset (chip_smoke.py and the tests
# set it to 0 and read it)
all_reduces = 0
_bound = {}
_events = None


def reset() -> None:
    global all_reduces
    all_reduces = 0


def backend_for(device) -> str:
    """The backend of a device's tensors: ``nccl`` on the card, ``gloo``
    on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def check_backend(group, device) -> None:
    """Raise unless ``group`` sums ``device``'s tensors with its own
    backend (``backend_for``); None (this process alone) passes."""
    if group is None:
        return
    import torch.distributed as dist
    have = str(dist.get_backend(group))
    want = backend_for(device)
    if want not in have:
        raise RuntimeError(
            f"tensors on {torch.device(device).type} all-reduce through "
            f"{want}, and the process group's backend is {have}: "
            f"initialize the group for the scene's device")


def axis_group(mesh, axis: str) -> Tuple[object, int, int]:
    """(group, this process's rank in it, its size) of the axis ``axis``
    of ``mesh``: a ``DeviceMesh`` with that dimension name, a process
    group (its one axis), or None (this process alone: no group, rank 0
    of 1)."""
    if mesh is None:
        return None, 0, 1
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        if axis not in names:
            raise KeyError(f"the mesh has no axis {axis!r} (axes {names})")
        return (mesh.get_group(axis), mesh.get_local_rank(axis),
                mesh.size(names.index(axis)))
    return mesh, dist.get_rank(mesh), dist.get_world_size(mesh)


def shard_range(n: int, rank: int, size: int) -> Tuple[int, int]:
    """Rows [lo, hi) of ``n`` that rank ``rank`` of ``size`` owns: chunks
    of ceil(n / size), the last one short."""
    per = -(-n // size)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


@contextlib.contextmanager
def bind(**axes):
    """Bind axis names to process groups for the duration of the block:
    ``with bind(mp=group): ...``."""
    old = dict(_bound)
    _bound.update(axes)
    try:
        yield
    finally:
        _bound.clear()
        _bound.update(old)


def group_of(axis: str):
    """The group bound to ``axis``; NameError where none is."""
    if axis not in _bound:
        raise NameError(
            f"unbound axis name: {axis} (no process group is bound to it; "
            f"a camera pass with map_psum_axis={axis!r} runs through "
            f"parallel.sharded_maps.make_sharded_vrl_render)")
    return _bound[axis]


@contextlib.contextmanager
def timed():
    """Bracket every all-reduce of a CUDA tensor in the block with CUDA
    events; yields the list of event pairs, which ``elapsed_s`` adds
    up."""
    global _events
    _events = events = []
    try:
        yield events
    finally:
        _events = None


def elapsed_s(events) -> float:
    """Device seconds of the all-reduces timed by ``events`` (waits for
    the last one)."""
    if not events:
        return 0.0
    events[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / 1e3


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; None: ``x``
    itself). Every rank of the group must make the same calls in the
    same order."""
    global all_reduces
    if group is None:
        return x
    import torch.distributed as dist
    y = x.detach().clone(memory_format=torch.contiguous_format)
    all_reduces += 1
    if _events is not None and y.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        b.record()
        _events.append((a, b))
    else:
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y

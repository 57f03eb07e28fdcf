"""Uniform hash grid for photon radiance estimates.

Port of ``mitsuba_nlvrl_tpu/ops/hashgrid.py``. Photons are binned into a
virtual uniform grid whose cell size is the query radius: they are sorted
by bucket id (the cell's 32-bit hash masked to H buckets, H a power of two
about twice the photon count) and a (H, 2) [start, end) range table is
built once. A radius query visits the 27 cells around the query point,
one range-table row each, and folds at most ``max_per_cell`` photons of
each cell in a vectorised (N, K) block. Bucket collisions are benign: the
fold's radius test rejects photons of other cells, and a bucket that two
neighbour cells share is visited once.

The hash multiplies and shifts uint32 values; it runs on int64 tensors
masked to 32 bits after every step (torch has no uint32 arithmetic on the
CPU), as ``core/rng.py``'s threefry does. The sort is stable and the
range search looks from the left, as the reference's are: the order inside
a bucket decides which photons a capped cell keeps.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

_MASK = 0xFFFFFFFF
_H1, _H2, _H3 = 0x8da6b343, 0xd8163841, 0xcb1ab31f
_GOLDEN = 0x9e3779b9

# the 27 neighbour offsets, dx fastest, as the reference visits them
_NEIGHBORS = [[dx, dy, dz] for dz in (-1, 0, 1) for dy in (-1, 0, 1)
              for dx in (-1, 0, 1)]


@functools.lru_cache(maxsize=8)
def _neighbors(device) -> torch.Tensor:
    """The (27, 3) int32 offsets on ``device``, made once: a host-to-device
    copy inside the gathers would wait for the device."""
    return torch.tensor(_NEIGHBORS, dtype=torch.int32, device=device)


class HashGrid(NamedTuple):
    cell_ranges: torch.Tensor    # (H, 2) int32 [start, end) into order
    order: torch.Tensor          # (P,) int32 photon index per sorted slot
    cell_size: torch.Tensor      # () float32
    origin: torch.Tensor         # (3,) grid origin (bbox lo)


def _mul32(a, k: int):
    """(a * k) mod 2^32 for a in [0, 2^32), k a 32-bit constant, without
    leaving int64's range: k is split into 16-bit halves."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash_cell(c):
    """(..., 3) int32 cells -> 32-bit hashes (int64 holding uint32)."""
    c = c.to(torch.int64) & _MASK       # two's complement, as uint32
    x = _mul32(c[..., 0], _H1)
    y = _mul32(c[..., 1], _H2)
    z = _mul32(c[..., 2], _H3)
    h = x ^ ((y + _GOLDEN + ((x << 6) & _MASK) + (x >> 2)) & _MASK)
    h = h ^ ((z + _GOLDEN + ((h << 6) & _MASK) + (h >> 2)) & _MASK)
    return h


def _n_buckets(P: int) -> int:
    """Bucket count: a power of two >= 2P (0.5 load factor), at most 2^21."""
    H = 1024
    while H < 2 * P:
        H *= 2
    return min(H, 1 << 21)


def _cell_of(x, origin, cell_size):
    return torch.floor((x - origin) / cell_size).to(torch.int32)


def build(positions, valid, origin, cell_size) -> HashGrid:
    """Sort photon indices by bucket and tabulate each bucket's range.
    Invalid photons sort to bucket H, past every real bucket. ``origin``
    and ``cell_size`` are tensors on the photons' device."""
    P = positions.shape[0]
    H = _n_buckets(P)
    dev = positions.device
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    bucket = _hash_cell(_cell_of(positions, origin, cell_size)) & (H - 1)
    bucket = torch.where(valid, bucket, H)
    order = torch.argsort(bucket, stable=True)
    ranges = torch.searchsorted(bucket[order],
                                torch.arange(H + 1, device=dev), right=False)
    cell_ranges = torch.stack([ranges[:-1], ranges[1:]],
                              dim=1).to(torch.int32)
    return HashGrid(cell_ranges=cell_ranges, order=order.to(torch.int32),
                    cell_size=cell_size, origin=origin)


def fold_neighbors(grid: HashGrid, x, active, fold_fn: Callable, init,
                   max_per_cell: int = 32):
    """Fold ``fold_fn(acc, photon_idx (N, K), ok (N, K)) -> acc`` over the
    photons in the 27 cells around each query point x (N, 3), one (N, K)
    candidate block a cell. The radius test is fold_fn's: the grid only
    makes sure that every photon within cell_size of x is visited. A
    cell's photons past ``max_per_cell`` are dropped."""
    P = grid.order.shape[0]
    H = grid.cell_ranges.shape[0]
    if P == 0:
        return init
    N = x.shape[0]
    dev = x.device
    base = _cell_of(x, grid.origin, grid.cell_size)
    offs = torch.arange(max_per_cell, dtype=torch.int32, device=dev)[None, :]
    neighbor = _neighbors(dev)
    # the 27 bucket ids, sorted per lane with repeats masked: two
    # neighbour cells may share a bucket, whose photons count once
    b = _hash_cell(base[:, None, :] + neighbor[None, :, :]) & (H - 1)
    b = torch.sort(b, dim=1).values
    dup = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=dev),
                     b[:, 1:] == b[:, :-1]], dim=1)
    order = grid.order.long()
    acc = init
    for i in range(neighbor.shape[0]):
        rng = grid.cell_ranges[b[:, i]]
        slots = rng[:, 0:1] + offs
        ok = active[:, None] & ~dup[:, i:i + 1] & (slots < rng[:, 1:2])
        idx = order[torch.clamp(slots, 0, P - 1).long()]
        acc = fold_fn(acc, idx, ok)
    return acc

"""Counter-based wavefront sampler over a threefry2x32 stream.

Port of ``mitsuba_nlvrl_tpu/core/rng.py``. The reference draws its random
numbers from ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable=True``); this module reproduces that stream
bit for bit for the calls the renderer makes: ``PRNGKey``, ``fold_in``,
``split`` and float32 ``uniform``. With the same seed both
packages therefore trace the same light paths.

Torch has no ``+``, ``<<`` or ``>>`` for ``uint32`` on the CPU, so the
generator works on ``int64`` tensors masked to 32 bits after every add and
shift; the same code runs on the card. Keys are ``(2,)`` int64 tensors on
the host: deriving a key is a handful of scalar operations, and only the
bulk ``uniform`` draws run on the wavefront's device. There is no global
torch RNG state anywhere in the port.

A draw can also be taken at given lanes of a larger, global wavefront
(``Lanes``): the elements of those lanes get the counters they have in
the draw of the whole wavefront, so a rank that renders a shard of the
wavefront draws exactly the numbers of its lanes in the reference's
global draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the
    key (k1, k2); all values are uint32 held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key_ints(key) -> Tuple[int, int]:
    return int(key[0]), int(key[1])


def _key(a, b) -> torch.Tensor:
    return torch.tensor([int(a), int(b)], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor. The reference
    runs with 32-bit integers, so only the low 32 bits of the seed count
    and the high key word is 0."""
    return _key(0, int(seed) & _MASK)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    k1, k2 = _key_ints(key)
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    a, b = threefry2x32(k1, k2, x0, x1)
    return _key(a[0], b[0])


def split(key, n: int = 2) -> Tuple[torch.Tensor, ...]:
    """``jax.random.split(key, n)``: the fold-like split of the
    partitionable threefry, key i hashing the counter pair (0, i)."""
    k1, k2 = _key_ints(key)
    a, b = threefry2x32(k1, k2, torch.zeros(n, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64))
    return tuple(_key(a[i], b[i]) for i in range(n))


class Lanes(NamedTuple):
    """Lanes ``ids`` (n,) int64 of a global wavefront of ``total`` lanes:
    a draw at these lanes takes the counters that their elements have in
    the draw of all ``total`` lanes."""
    ids: torch.Tensor
    total: int


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _counters(shape, device, lanes: Optional[Lanes], axis: int):
    """The row-major counters of the elements of ``shape``. With
    ``lanes``, ``shape[axis]`` counts the given lanes and the counters
    are those of the same elements in the global shape, whose ``axis``
    holds ``lanes.total`` lanes."""
    shape = tuple(int(s) for s in shape)
    if lanes is None:
        return torch.arange(_prod(shape), dtype=torch.int64,
                            device=device).reshape(shape)
    if shape[axis] != lanes.ids.shape[0]:
        raise ValueError(f"shape {shape} has {shape[axis]} lanes on axis "
                         f"{axis}, the lane ids {lanes.ids.shape[0]}")
    outer, inner = _prod(shape[:axis]), _prod(shape[axis + 1:])
    ids = lanes.ids.to(device=device, dtype=torch.int64)
    c = (torch.arange(outer, dtype=torch.int64, device=device)[:, None, None]
         * (lanes.total * inner) + ids[None, :, None] * inner
         + torch.arange(inner, dtype=torch.int64, device=device)[None, None])
    return c.reshape(shape)


def _threefry_words(key, shape, device, lanes=None, axis=0):
    """The two threefry output words of each element, row-major
    counters (of the global shape, where ``lanes`` are given). A 64-bit
    counter is hashed as its (high, low) words, as the partitionable
    threefry splits its element index: below 2^32 the high word is 0."""
    k1, k2 = _key_ints(key)
    counts = _counters(shape, device, lanes, axis)
    return threefry2x32(k1, k2, counts >> 32, counts & _MASK)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """32 random bits per element (as int64), row-major counters."""
    a, b = _threefry_words(key, shape, device)
    return a ^ b


def uniform(key, shape, device=None, dtype=torch.float32,
            lanes: Optional[Lanes] = None, axis: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1): the top
    mantissa bits of the element's random bits as a float in [1, 2),
    minus one. float32 takes 23 of the 32 bits ``a ^ b``; float64 (the
    reference's default float under x64) 52 of the 64 bits ``a:b``.

    ``lanes``: ``shape[axis]`` holds these lanes of a wavefront of
    ``lanes.total``; the result is the slice at ``lanes.ids`` (on
    ``axis``) of the draw of the global shape."""
    a, b = _threefry_words(key, shape, device, lanes, axis)
    if dtype == torch.float64:
        return ((a << 20) | (b >> 12)).to(torch.float64) * 2.0 ** -52
    return ((a ^ b) >> 9).to(torch.float32) * (1.0 / (1 << 23))


class Sampler(NamedTuple):
    """Counter-based sampler: a key plus an integer dimension counter.

    Each draw takes a whole wavefront of values from ``fold_in(key, dim)``
    and returns a new sampler with the next dimension, so every (lane,
    dimension) pair sees its own deterministic stream. ``rays`` counts the
    rays traced (live lanes at every intersection site) as a device scalar,
    so counting never waits on the device. ``at``: the lanes' places in a
    global wavefront (``Lanes``), where the sampler draws for a shard of
    it; None for a wavefront of its own."""
    key: torch.Tensor
    dim: int
    lanes: int
    rays: torch.Tensor
    device: object
    at: Optional[Lanes] = None

    @staticmethod
    def make(key, lanes: int, device=None,
             at: Optional[Lanes] = None) -> "Sampler":
        rays = torch.zeros((), dtype=torch.float32, device=device)
        return Sampler(key, 0, lanes, rays, device, at)

    def count_rays(self, mask) -> "Sampler":
        """Record ``sum(mask)`` rays traced."""
        return self._replace(rays=self.rays + mask.sum(dtype=torch.float32))

    def next_1d(self) -> Tuple[torch.Tensor, "Sampler"]:
        u = uniform(fold_in(self.key, self.dim), (self.lanes,), self.device,
                    lanes=self.at)
        return u, self._replace(dim=self.dim + 1)

    def next_2d(self) -> Tuple[torch.Tensor, "Sampler"]:
        u = uniform(fold_in(self.key, self.dim), (self.lanes, 2),
                    self.device, lanes=self.at)
        return u, self._replace(dim=self.dim + 1)

    def fork(self, salt: int) -> "Sampler":
        """Independent sampler for a sub-pass (on the same lanes)."""
        return Sampler.make(fold_in(self.key, (0x9e3779b9 + salt) & _MASK),
                            self.lanes, self.device, self.at)


def seed_for(base_key, *indices) -> torch.Tensor:
    """The key of a (pass, chunk, device, ...) tuple: ``fold_in`` of each
    index in turn."""
    k = base_key
    for ix in indices:
        k = fold_in(k, ix)
    return k

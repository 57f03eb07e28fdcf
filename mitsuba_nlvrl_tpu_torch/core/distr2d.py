"""Hierarchical sample warping of a bilinear-interpolant density.

Port of the ``Hierarchical2D`` part of ``mitsuba_nlvrl_tpu/core/distr2d.py``
(the environment map's warp): a 2D density given by bilinear
interpolation of an (h, w) node grid, sampled by a coarse-to-fine MIP
descent with little shear, inverted exactly, and evaluated. Levels are
row-major (1, h, w) arrays: one slice, without the reference's
conditioning parameters (those, ``Marginal2D`` and the discrete variant
serve the measured BSDFs, ROADMAP item 10). The tables are built in
numpy, as the reference builds them, so both packages hold the same
bits; the descent is a host loop over the levels with every lane in
lockstep.

Each level is padded to even sizes with zero cells, and a lane's 2x2
block reads past the end of the next finer level only where it sits in
a pad cell, which the descent never selects. The reference leans on JAX
clamping those reads; here the indices are clamped explicitly.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import math as m


class Hierarchical2D(NamedTuple):
    nodes: torch.Tensor                 # (1, h, w) normalized node values
    levels: Tuple[torch.Tensor, ...]    # coarsest (<=2x2) ... finest patches


def build_hierarchical_np(data: np.ndarray):
    """(nodes, levels) as float32 numpy arrays for an (h, w) grid of node
    values, normalized so that the interpolant integrates to 1 over the
    unit square."""
    dd = np.asarray(data, np.float64)
    h, w = dd.shape[-2], dd.shape[-1]
    d = dd.reshape(-1, h, w)
    if h < 2 or w < 2:          # degenerate 1-node axis: constant density
        d = np.pad(d, ((0, 0), (0, 2 - h if h < 2 else 0),
                       (0, 2 - w if w < 2 else 0)), mode='edge')
        h, w = d.shape[1:]
    ph, pw = h - 1, w - 1
    patch = 0.25 * (d[:, :-1, :-1] + d[:, :-1, 1:]
                    + d[:, 1:, :-1] + d[:, 1:, 1:])
    scale = (ph * pw) / np.maximum(patch.sum(axis=(1, 2), keepdims=True),
                                   1e-30)
    nodes = d * scale
    levels = []
    cur = patch * scale
    while True:
        hp = cur.shape[1] + (cur.shape[1] & 1)
        wp = cur.shape[2] + (cur.shape[2] & 1)
        padded = np.zeros((cur.shape[0], hp, wp))
        padded[:, :cur.shape[1], :cur.shape[2]] = cur
        levels.append(padded)
        if hp <= 2 and wp <= 2:
            break
        cur = (padded[:, 0::2, 0::2] + padded[:, 0::2, 1::2]
               + padded[:, 1::2, 0::2] + padded[:, 1::2, 1::2])
    return (nodes.astype(np.float32),
            tuple(lv.astype(np.float32) for lv in reversed(levels)))


def build_hierarchical(data: np.ndarray, device=None) -> Hierarchical2D:
    nodes, levels = build_hierarchical_np(data)
    return Hierarchical2D(
        nodes=torch.as_tensor(nodes, device=device),
        levels=tuple(torch.as_tensor(lv, device=device) for lv in levels))


def _at(L, y, x):
    """L[0, y, x] with both indices clamped into the level."""
    h, w = L.shape[1], L.shape[2]
    return L[0, m.clip(y, 0, h - 1), m.clip(x, 0, w - 1)]


def _block(L, oy, ox):
    y, x = 2 * oy, 2 * ox
    return _at(L, y, x), _at(L, y, x + 1), _at(L, y + 1, x), \
        _at(L, y + 1, x + 1)


def _interval_to_linear(v0, v1, s):
    """Inverse CDF of the density lerp(v0, v1, t) on [0, 1]."""
    non_const = torch.abs(v0 - v1) > 1e-4 * (v0 + v1)
    num = v0 - m.safe_sqrt((1.0 - s) * v0 * v0 + s * v1 * v1)
    den = torch.where(non_const, v0 - v1, 1.0)
    return torch.where(non_const, num / den, s)


def _linear_to_interval(v0, v1, t):
    """Inverse of _interval_to_linear."""
    non_const = torch.abs(v0 - v1) > 1e-4 * (v0 + v1)
    den = torch.where(non_const, v0 + v1, 1.0)
    return torch.where(non_const, t * ((2.0 - t) * v0 + t * v1) / den, t)


def _node_corners(dist, oy, ox):
    n = dist.nodes
    return (n[0, oy, ox], n[0, oy, ox + 1], n[0, oy + 1, ox],
            n[0, oy + 1, ox + 1])


def _cell(dist, pos):
    """The node cell of pos and the position inside it."""
    h, w = dist.nodes.shape[1:]
    px = m.clip(pos[..., 0], 0.0, 1.0) * (w - 1)
    py = m.clip(pos[..., 1], 0.0, 1.0) * (h - 1)
    ox = m.clip(px.to(torch.int64), 0, w - 2)
    oy = m.clip(py.to(torch.int64), 0, h - 2)
    return ox, oy, px - ox, py - oy


def sample_hierarchical(dist: Hierarchical2D, u2):
    """Hierarchical sample warping: (pos (N, 2) in [0, 1]^2, pdf), the pdf
    the unit-square density."""
    sx = m.clip(u2[..., 0], 0.0, 1.0)
    sy = m.clip(u2[..., 1], 0.0, 1.0)
    ox = torch.zeros(sx.shape, dtype=torch.int64, device=sx.device)
    oy = torch.zeros_like(ox)
    for L in dist.levels:                       # coarsest -> finest patches
        v00, v10, v01, v11 = _block(L, oy, ox)
        r0, r1 = v00 + v10, v01 + v11
        sy = sy * (r0 + r1)
        my = sy > r0
        oy = 2 * oy + my
        sy = torch.where(my, sy - r0, sy) \
            / m.clip(torch.where(my, r1, r0), min=1e-30)
        c0 = torch.where(my, v01, v00)
        c1 = torch.where(my, v11, v10)
        sx = sx * (c0 + c1)
        mx = sx > c0
        ox = 2 * ox + mx
        sx = torch.where(mx, sx - c0, sx) \
            / m.clip(torch.where(mx, c1, c0), min=1e-30)
        sx = m.clip(sx, 0.0, 1.0)
        sy = m.clip(sy, 0.0, 1.0)
    h, w = dist.nodes.shape[1:]
    ox = m.clip(ox, max=w - 2)
    oy = m.clip(oy, max=h - 2)
    v00, v10, v01, v11 = _node_corners(dist, oy, ox)
    # square_to_bilinear
    sy = _interval_to_linear(v00 + v10, v01 + v11, sy)
    c0 = v00 + sy * (v01 - v00)
    c1 = v10 + sy * (v11 - v10)
    sx = _interval_to_linear(c0, c1, sx)
    pdf = c0 + sx * (c1 - c0)
    pos = torch.stack([(ox + sx) / (w - 1), (oy + sy) / (h - 1)], dim=-1)
    return pos, pdf


def invert_hierarchical(dist: Hierarchical2D, pos):
    """Exact inverse of sample_hierarchical: (u2, pdf)."""
    ox, oy, sx, sy = _cell(dist, pos)
    v00, v10, v01, v11 = _node_corners(dist, oy, ox)
    # bilinear_to_square
    c0 = v00 + sy * (v01 - v00)
    c1 = v10 + sy * (v11 - v10)
    pdf = c0 + sx * (c1 - c0)
    sx = _linear_to_interval(c0, c1, sx)
    sy = _linear_to_interval(v00 + v10, v01 + v11, sy)
    for L in reversed(dist.levels):            # finest patches -> coarsest
        v00, v10, v01, v11 = _block(L, oy >> 1, ox >> 1)
        xm = (ox & 1) > 0
        ym = (oy & 1) > 0
        r0, r1 = v00 + v10, v01 + v11
        c0 = torch.where(ym, v01, v00)
        c1 = torch.where(ym, v11, v10)
        sy = sy * torch.where(ym, r1, r0) + torch.where(ym, r0, 0.0)
        sy = sy / m.clip(r0 + r1, min=1e-30)
        sx = sx * torch.where(xm, c1, c0) + torch.where(xm, c0, 0.0)
        sx = sx / m.clip(c0 + c1, min=1e-30)
        sx = m.clip(sx, 0.0, 1.0)
        sy = m.clip(sy, 0.0, 1.0)
        ox = ox >> 1
        oy = oy >> 1
    return torch.stack([sx, sy], dim=-1), pdf


def eval_hierarchical(dist: Hierarchical2D, pos):
    """Unit-square density at pos."""
    ox, oy, fx, fy = _cell(dist, pos)
    v00, v10, v01, v11 = _node_corners(dist, oy, ox)
    return ((1.0 - fy) * ((1.0 - fx) * v00 + fx * v10)
            + fy * ((1.0 - fx) * v01 + fx * v11))

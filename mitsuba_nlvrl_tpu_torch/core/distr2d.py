"""2D warps of a bilinear-interpolant density.

Port of ``mitsuba_nlvrl_tpu/core/distr2d.py``. ``Hierarchical2D`` (the
environment map's warp): a 2D density given by bilinear interpolation of
an (h, w) node grid, sampled by a coarse-to-fine MIP descent with little
shear, inverted exactly, and evaluated. Levels are row-major (1, h, w)
arrays: one slice, without conditioning parameters, which no caller
gives it. ``Marginal2D`` (the measured BSDFs' warps) and its discrete
variant: the same density sampled through a marginal CDF over rows and a
conditional CDF over columns, conditioned on up to three parameters whose
slices are interpolated linearly (2^D corner slices a lookup). The tables
are built in numpy, as the reference builds them, so both packages hold
the same bits; the descent and the binary searches are host loops with
every lane in lockstep.

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


# --- Marginal2D ---------------------------------------------------------------


class Marginal2D(NamedTuple):
    data: torch.Tensor       # (S, h, w) densities (normalized per slice)
    marg_cdf: torch.Tensor   # (S, h-1)
    cond_cdf: torch.Tensor   # (S, h, w-1), (S, h-1, w-1) for the discrete
    param_values: Tuple[torch.Tensor, ...]   # D arrays of slice coordinates

    @property
    def h(self):
        return self.data.shape[1]

    @property
    def w(self):
        return self.data.shape[2]


class Marginal2DDiscrete(Marginal2D):
    """The discrete variant's tables (``cond_cdf`` (S, h-1, w-1))."""


def _to_marginal(cls, d, marg, cond, param_values, device, dtype):
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device) \
            .to(dtype)
    return cls(t(d), t(marg), t(cond), tuple(t(p) for p in param_values))


def build(data: np.ndarray, param_values=(), normalize: bool = True,
          device=None, dtype=torch.float32) -> Marginal2D:
    """data: (*param_res, h, w) densities, one coordinate array per leading
    axis in ``param_values``. The tables are rounded to float32 as the
    reference's are, then held in ``dtype``."""
    h, w = data.shape[-2], data.shape[-1]
    d = np.asarray(data, np.float64).reshape(-1, h, w)
    scale_x = 0.5 / (w - 1)
    scale_y = 0.5 / (h - 1)
    cond = np.cumsum(scale_x * (d[:, :, :-1] + d[:, :, 1:]), axis=2)
    sums = cond[:, :, -1]                                    # (S, h)
    marg = np.cumsum(scale_y * (sums[:, :-1] + sums[:, 1:]), axis=1)
    if normalize:
        norm = 1.0 / np.maximum(marg[:, -1:], 1e-30)         # (S, 1)
        d = d * norm[:, :, None]
        cond = cond * norm[:, :, None]
        marg = marg * norm
    return _to_marginal(Marginal2D, d, marg, cond, param_values, device,
                        dtype)


def build_discrete(data: np.ndarray, param_values=(), normalize: bool = True,
                   device=None, dtype=torch.float32) -> Marginal2DDiscrete:
    """The discrete variant's tables: a CDF over bilinear patch integrals
    by rows, then by columns inside a row."""
    h, w = data.shape[-2], data.shape[-1]
    d = np.asarray(data, np.float64).reshape(-1, h, w)
    scale = 0.25 / ((w - 1) * (h - 1))
    patch = scale * (d[:, :-1, :-1] + d[:, :-1, 1:]
                     + d[:, 1:, :-1] + d[:, 1:, 1:])      # (S, h-1, w-1)
    cond = np.cumsum(patch, axis=2)
    marg = np.cumsum(cond[:, :, -1], axis=1)
    if normalize:
        norm = 1.0 / np.maximum(marg[:, -1:], 1e-30)
        d = d * norm[:, :, None]
        cond = cond * norm[:, :, None]
        marg = marg * norm
    return _to_marginal(Marginal2DDiscrete, d, marg, cond, param_values,
                        device, dtype)


def _mk_lookup(dist: Marginal2D, params):
    """lookup(arr, *inner): the 2^D corner slices of the parameters,
    interpolated linearly. A parameter is rounded to float32 as the
    reference rounds it; a bracket is found with a right search, clamped
    to the grid's last segment. A corner past the last slice (weight 0
    on a one-node axis) reads the last slice, as JAX clamps a gather."""
    pv = dist.param_values
    assert len(params) == len(pv), "parameter count mismatch"
    idxs, wts, strides = [], [], []
    stride = 1
    for p in reversed(pv):
        strides.insert(0, stride)
        stride *= int(p.shape[0])
    for nodes, x in zip(pv, params):
        n = int(nodes.shape[0])
        x = torch.as_tensor(x).to(torch.float32)
        if n == 1:
            idxs.append(torch.zeros(x.shape, dtype=torch.int64,
                                    device=x.device))
            wts.append((1.0, 0.0))
            continue
        xs = x.to(nodes.dtype)
        i = m.clip(torch.searchsorted(nodes, xs.contiguous(), right=True)
                   - 1, 0, n - 2)
        p0, p1 = nodes[i], nodes[i + 1]
        w1 = m.clip((x - p0) / m.clip(p1 - p0, min=1e-20), 0.0, 1.0)
        idxs.append(i)
        wts.append((1.0 - w1, w1))
    corners = [(0, 1.0)]
    if idxs:
        corners = []
        for corner in range(1 << len(idxs)):
            sidx, wgt = 0, 1.0
            for dim in range(len(idxs)):
                bit = (corner >> dim) & 1
                sidx = sidx + (idxs[dim] + bit) * strides[dim]
                wgt = wgt * wts[dim][bit]
            corners.append((m.clip(sidx, max=stride - 1), wgt))

    def lookup(arr, *inner):
        out = 0.0
        for sidx, wgt in corners:
            out = out + wgt * arr[(sidx,) + inner]
        return out
    return lookup


def _binary_search(n: int, pred, lo, hi):
    """The first index in [lo, hi] where the monotone ``pred`` is False,
    in the reference's fixed number of steps (a flat CDF run, a row of
    zero density, ends where the reference's search ends)."""
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        cont = lo < hi
        mid = (lo + hi) >> 1
        go = pred(mid) & cont
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(cont & ~go, mid, hi)
    return lo


def _sample_segment(sample, inv_width, v0, v1):
    non_const = torch.abs(v0 - v1) > 1e-4 * (v0 + v1)
    divisor = torch.where(non_const, v0 - v1, v0 + v1)
    s = sample * 2.0 * inv_width
    s = torch.where(non_const, v0 - m.safe_sqrt(v0 * v0 + s * (v1 - v0)), s)
    return torch.where(divisor != 0.0,
                       s / torch.where(divisor != 0.0, divisor, 1.0), s)


def _invert_segment(sample, width, v0, v1):
    return sample * ((1.0 - 0.5 * sample) * v0 + 0.5 * sample * v1) * width


def _search_bounds(like, hi):
    lo = torch.zeros(like.shape, dtype=torch.int64, device=like.device)
    return lo, torch.full_like(lo, hi)


def _cell2(dist, pos):
    h, w = dist.h, dist.w
    px = m.clip(pos[..., 0], 0.0, 1.0) * (w - 1)
    py = m.clip(pos[..., 1], 0.0, 1.0) * (h - 1)
    col = m.clip(px.to(torch.int64), 0, w - 2)
    row = m.clip(py.to(torch.int64), 0, h - 2)
    return col, row, px - col, py - row


def _corner_values(lookup, dist, row, col):
    return (lookup(dist.data, row, col), lookup(dist.data, row, col + 1),
            lookup(dist.data, row + 1, col),
            lookup(dist.data, row + 1, col + 1))


def sample(dist: Marginal2D, u2, params=()):
    """Warp uniform (N, 2) samples: (pos (N, 2) in [0, 1]^2, pdf)."""
    lookup = _mk_lookup(dist, params)
    h, w = dist.h, dist.w
    n_marg = h - 1
    sx = m.clip(u2[..., 0], 1e-6, 1.0 - 1e-6)
    sy = m.clip(u2[..., 1], 1e-6, 1.0 - 1e-6)

    def fetch_marginal(idx):
        return lookup(dist.marg_cdf, idx)

    row = _binary_search(
        n_marg, lambda i: fetch_marginal(m.clip(i, 0, n_marg - 1)) < sy,
        *_search_bounds(sy, n_marg - 1))
    sy = sy - torch.where(row > 0, fetch_marginal(m.clip(row - 1, min=0)),
                          0.0)
    r0 = lookup(dist.cond_cdf, row, w - 2)
    r1 = lookup(dist.cond_cdf, row + 1, w - 2)
    sy = _sample_segment(sy, float(h - 1), r0, r1)
    sx = sx * ((1.0 - sy) * r0 + sy * r1)

    def fetch_conditional(idx):
        v0 = lookup(dist.cond_cdf, row, idx)
        v1 = lookup(dist.cond_cdf, row + 1, idx)
        return (1.0 - sy) * v0 + sy * v1

    col = _binary_search(
        w - 1, lambda i: fetch_conditional(m.clip(i, 0, w - 2)) < sx,
        *_search_bounds(sx, w - 2))
    sx = sx - torch.where(col > 0,
                          fetch_conditional(m.clip(col - 1, min=0)), 0.0)
    v00, v10, v01, v11 = _corner_values(lookup, dist, row, col)
    c0 = (1.0 - sy) * v00 + sy * v01
    c1 = (1.0 - sy) * v10 + sy * v11
    sx = _sample_segment(sx, float(w - 1), c0, c1)
    pdf = (1.0 - sx) * c0 + sx * c1
    pos = torch.stack([(col + sx) / (w - 1), (row + sy) / (h - 1)], dim=-1)
    return pos, pdf


def invert(dist: Marginal2D, pos, params=()):
    """Inverse of ``sample``: (uniform sample (N, 2), pdf)."""
    lookup = _mk_lookup(dist, params)
    h, w = dist.h, dist.w
    col, row, fx, fy = _cell2(dist, pos)
    v00, v10, v01, v11 = _corner_values(lookup, dist, row, col)
    c0 = (1.0 - fy) * v00 + fy * v01
    c1 = (1.0 - fy) * v10 + fy * v11
    pdf = (1.0 - fx) * c0 + fx * c1
    sx = _invert_segment(fx, 1.0 / (w - 1), c0, c1)

    def fetch_conditional(idx):
        v0 = lookup(dist.cond_cdf, row, idx)
        v1 = lookup(dist.cond_cdf, row + 1, idx)
        return (1.0 - fy) * v0 + fy * v1

    sx = sx + torch.where(col > 0,
                          fetch_conditional(m.clip(col - 1, min=0)), 0.0)
    r0 = lookup(dist.cond_cdf, row, w - 2)
    r1 = lookup(dist.cond_cdf, row + 1, w - 2)
    sx = sx / m.clip((1.0 - fy) * r0 + fy * r1, min=1e-20)
    sy = _invert_segment(fy, 1.0 / (h - 1), r0, r1)
    sy = sy + torch.where(row > 0, lookup(dist.marg_cdf,
                                          m.clip(row - 1, min=0)), 0.0)
    return torch.stack([sx, sy], dim=-1), pdf


def eval(dist: Marginal2D, pos, params=()):
    """Interpolated density at pos (N, 2)."""
    lookup = _mk_lookup(dist, params)
    col, row, fx, fy = _cell2(dist, pos)
    v00, v10, v01, v11 = _corner_values(lookup, dist, row, col)
    return ((1.0 - fy) * ((1.0 - fx) * v00 + fx * v10)
            + fy * ((1.0 - fx) * v01 + fx * v11))


def sample_discrete(dist: Marginal2DDiscrete, u2, params=()):
    """The discrete variant: a patch by the CDFs, then the exact bilinear
    warp inside it. (pos (N, 2) in [0, 1]^2, pdf)."""
    lookup = _mk_lookup(dist, params)
    h, w = dist.h, dist.w
    n_marg = h - 1
    sx = m.clip(u2[..., 0], 1e-6, 1.0 - 1e-6)
    sy = m.clip(u2[..., 1], 1e-6, 1.0 - 1e-6)

    def fetch_marg(idx):
        return lookup(dist.marg_cdf, idx)

    row = _binary_search(
        n_marg, lambda i: fetch_marg(m.clip(i, 0, n_marg - 1)) < sy,
        *_search_bounds(sy, n_marg - 1))
    cdf0 = torch.where(row > 0, fetch_marg(m.clip(row - 1, min=0)), 0.0)
    sy = (sy - cdf0) * m.safe_rcp(fetch_marg(row) - cdf0)

    def fetch_cond(idx):
        return lookup(dist.cond_cdf, row, idx)

    sx = sx * fetch_cond(w - 2)
    col = _binary_search(
        w - 1, lambda i: fetch_cond(m.clip(i, 0, w - 2)) < sx,
        *_search_bounds(sx, w - 2))
    ccdf0 = torch.where(col > 0, fetch_cond(m.clip(col - 1, min=0)), 0.0)
    sx = (sx - ccdf0) * m.safe_rcp(fetch_cond(col) - ccdf0)
    v00, v10, v01, v11 = _corner_values(lookup, dist, row, col)
    sy = _interval_to_linear(v00 + v10, v01 + v11, sy)
    c0 = v00 + sy * (v01 - v00)
    c1 = v10 + sy * (v11 - v10)
    sx = _interval_to_linear(c0, c1, sx)
    pdf = c0 + sx * (c1 - c0)
    pos = torch.stack([(col + sx) / (w - 1), (row + sy) / (h - 1)], dim=-1)
    return pos, pdf


def invert_discrete(dist: Marginal2DDiscrete, pos, params=()):
    """Exact inverse of ``sample_discrete``: (u2, pdf)."""
    lookup = _mk_lookup(dist, params)
    col, row, fx, fy = _cell2(dist, pos)
    v00, v10, v01, v11 = _corner_values(lookup, dist, row, col)
    c0 = v00 + fy * (v01 - v00)
    c1 = v10 + fy * (v11 - v10)
    pdf = c0 + fx * (c1 - c0)
    sx = _linear_to_interval(c0, c1, fx)
    sy = _linear_to_interval(v00 + v10, v01 + v11, fy)

    def fetch_cond(idx):
        return lookup(dist.cond_cdf, row, idx)

    ccdf0 = torch.where(col > 0, fetch_cond(m.clip(col - 1, min=0)), 0.0)
    sx = (ccdf0 + sx * (fetch_cond(col) - ccdf0)) \
        * m.safe_rcp(fetch_cond(dist.w - 2))
    cdf0 = torch.where(row > 0, lookup(dist.marg_cdf,
                                       m.clip(row - 1, min=0)), 0.0)
    sy = cdf0 + sy * (lookup(dist.marg_cdf, row) - cdf0)
    return torch.stack([sx, sy], dim=-1), pdf

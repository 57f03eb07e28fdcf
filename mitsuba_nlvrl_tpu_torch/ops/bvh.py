"""BVH build (host) and stack traversal (device).

Port of ``mitsuba_nlvrl_tpu/ops/bvh.py``. ``build`` runs the binned-SAH
builder of ``native/bvh_native.cpp`` (the reference's own source; there is
no numpy fallback, see ``native``). ``traverse`` walks the tree for a
wavefront of rays with a per-lane stack of node ids, as the reference's
``lax.while_loop`` does, as a host loop of eager torch operations:

- a step pops one node per active lane; an inner node whose box the ray
  enters pushes b then a (a pops first; no near-first order), a leaf
  tests its LEAF_SIZE triangles as one bundle and keeps the first minimum;
- the push index clamps at STACK_DEPTH - 1, so an overflow overwrites the
  top of the stack;
- the best t starts at maxt and a hit must be strictly nearer; an any-hit
  lane empties its stack at its first hit;
- after MAX_TRAV_ITERS steps lanes still active keep their current best.

The host reads the number of live lanes every CHECK_EVERY steps (a step
changes nothing for a lane whose stack is empty, so the steps run past the
last live lane's end change nothing) and then drops finished lanes from
the working set once it has halved. ``stats`` counts calls, steps and the
lanes cut at MAX_TRAV_ITERS.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import sync

LEAF_SIZE = 8
STACK_DEPTH = 48
MAX_TRAV_ITERS = 4096
CHECK_EVERY = 8
# the working set shrinks to the live lanes once they are at most this
# share of it
COMPACT_BELOW = 0.5

# since the last reset_stats(): traverse calls, steps run, the most steps of
# one call, lanes still active at MAX_TRAV_ITERS
stats = {'calls': 0, 'steps': 0, 'max_steps': 0, 'lanes_cut': 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


class BVHArrays(NamedTuple):
    node_lo: object     # (M, 3) float32
    node_hi: object     # (M, 3) float32
    node_a: object      # (M,) int32: left child | tri offset (leaf)
    node_b: object      # (M,) int32: right child | tri count (leaf)
    node_leaf: object   # (M,) bool
    order: object       # (T,) int32 reordered tri -> original tri


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BVHArrays:
    """The binned-SAH BVH of the triangles, as numpy arrays (nodes in
    preorder)."""
    from ..native import build_bvh
    return BVHArrays(*build_bvh(v0, e1, e2, LEAF_SIZE))


def _tri_bundle_hit(ray, cur_best, tv):
    """Test a bundle of triangles per lane; tv (N, L, 9) holds v0, e1, e2.
    Returns (t, u, v, ok): the reference's arithmetic in its order, with
    the cross products as (N, L, 3) operations on rotated components (the
    x of ``a.roll(-1)`` is a's y, of ``a.roll(1)`` its z)."""
    v0, e1, e2 = tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]
    p = ray.d_yzx * e2.roll(1, -1) - ray.d_zxy * e2.roll(-1, -1)
    det = _dot(e1 * p)
    nondegen = det.abs() > 1e-12
    inv_det = torch.where(nondegen, 1.0 / det, 0.0)
    to = ray.o - v0
    u = _dot(to * p) * inv_det
    q = to.roll(-1, -1) * e1.roll(1, -1) - to.roll(1, -1) * e1.roll(-1, -1)
    v = _dot(ray.d * q) * inv_det
    t = _dot(e2 * q) * inv_det
    ok = nondegen & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t >= ray.mint) & (t < cur_best[:, None])
    return t, u, v, ok


def _dot(m):
    """x + y + z of the products m (..., 3), summed in that order."""
    return m[..., 0] + m[..., 1] + m[..., 2]


class _Lanes:
    """The working set: per-lane ray and traversal state, and the ids of
    its lanes in the call's wavefront (None: all of them, in order). The
    ray's fields are shaped to broadcast against a leaf's (N, L, 3)
    bundle and a node's (N, 6) box; the stack has a sink column at
    STACK_DEPTH that takes the writes of lanes that push nothing."""

    FIELDS = ('o', 'd', 'd_yzx', 'd_zxy', 'o2', 'inv_d2', 'mint', 'stack',
              'sp', 'best_t', 'hit_t', 'best_i', 'best_u', 'best_v')

    def __init__(self, **kw):
        self.ids = None
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    def keep(self, live: torch.Tensor) -> None:
        for k in self.FIELDS:
            setattr(self, k, getattr(self, k)[live])
        self.ids = live if self.ids is None else self.ids[live]


_SINK = STACK_DEPTH
_TOP = STACK_DEPTH - 1


def _step(boxes, links, tris, w: _Lanes, ar, any_hit):
    """One iteration of the reference's loop body on the working set;
    ``boxes`` (M, 6) holds each node's lo and hi, ``links`` (M, 3) its a,
    b and leaf flag."""
    act = w.sp > 0
    sp_new = torch.clamp(w.sp - 1, min=0)
    node = w.stack.gather(1, sp_new.long()[:, None])[:, 0]
    node = torch.where(act, node, 0).long()
    t01 = (boxes[node] - w.o2) * w.inv_d2
    t0, t1 = t01[:, 0:3], t01[:, 3:6]
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    box_hit = act & (tnear <= tfar) & (tfar >= w.mint[:, 0]) \
        & (tnear < w.best_t)
    link = links[node]
    a, b, is_leaf = link[:, 0], link[:, 1], link[:, 2] != 0

    # leaf: the bundle of up to LEAF_SIZE triangles (a = offset, b = count)
    do_leaf = box_hit & is_leaf
    lane_ids = a[:, None] + ar[None, :]
    safe = torch.clamp(lane_ids, 0, tris.shape[0] - 1).long()
    t, u, v, ok = _tri_bundle_hit(w, w.best_t, tris[safe])
    ok = ok & (ar[None, :] < b[:, None]) & do_leaf[:, None]
    t = torch.where(ok, t, torch.inf)
    tj, jmin = t.min(dim=1)
    better = torch.isfinite(tj) & (tj < w.best_t)
    w.best_t = torch.where(better, tj, w.best_t)
    w.hit_t = torch.where(better, tj, w.hit_t)
    jm = jmin[:, None]
    w.best_i = torch.where(better, lane_ids.gather(1, jm)[:, 0], w.best_i)
    w.best_u = torch.where(better, u.gather(1, jm)[:, 0], w.best_u)
    w.best_v = torch.where(better, v.gather(1, jm)[:, 0], w.best_v)
    if any_hit:
        # a lane is done at its first hit: empty its stack
        sp_new = torch.where(better, 0, sp_new)

    # inner node: push b, then a (clamped at the top of the stack)
    push = box_hit & ~is_leaf
    i1 = torch.where(push, torch.clamp(sp_new, max=_TOP), _SINK)
    w.stack.scatter_(1, i1.long()[:, None], b[:, None])
    sp1 = torch.where(push, torch.clamp(sp_new + 1, max=_TOP), sp_new)
    w.stack.scatter_(1, torch.where(push, sp1, _SINK).long()[:, None],
                     a[:, None])
    w.sp = torch.where(push, torch.clamp(sp1 + 1, max=_TOP), sp1)


def traverse(bvh: BVHArrays, tri_v0, tri_e1, tri_e2, o, d, mint, maxt,
             any_hit: bool = False):
    """Nearest (or any) hit of rays (o, d) in [mint, maxt) against the BVH
    over the reordered triangles ``tri_*``. Returns (t, reordered idx, u,
    v): t is inf and idx -1 on a miss."""
    N, dev, ft = o.shape[0], o.device, o.dtype   # float64 when double
    hit_t = torch.full((N,), torch.inf, dtype=ft, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((N,), dtype=ft, device=dev)
    best_v = torch.zeros((N,), dtype=ft, device=dev)
    stats['calls'] += 1
    if N == 0 or tri_v0.shape[0] == 0:
        return hit_t, best_i, best_u, best_v
    inv_d = 1.0 / torch.where(d.abs() > 1e-20, d, 1e-20)
    w = _Lanes(
        o=o[:, None, :], d=d[:, None, :],
        d_yzx=d.roll(-1, -1)[:, None, :], d_zxy=d.roll(1, -1)[:, None, :],
        o2=torch.cat([o, o], 1), inv_d2=torch.cat([inv_d, inv_d], 1),
        mint=mint[:, None],
        stack=torch.zeros((N, STACK_DEPTH + 1), dtype=torch.int32,
                          device=dev),
        sp=torch.ones((N,), dtype=torch.int32, device=dev),
        best_t=torch.where(torch.isfinite(maxt), maxt, torch.inf),
        hit_t=hit_t.clone(), best_i=best_i.clone(), best_u=best_u.clone(),
        best_v=best_v.clone())
    tris = torch.cat([tri_v0, tri_e1, tri_e2], dim=1)
    boxes = torch.cat([bvh.node_lo, bvh.node_hi], 1)
    links = torch.stack([bvh.node_a, bvh.node_b,
                         bvh.node_leaf.to(torch.int32)], 1)
    ar = torch.arange(LEAF_SIZE, dtype=torch.int32, device=dev)
    it, n_live = 0, N
    while it < MAX_TRAV_ITERS and n_live:
        for _ in range(min(CHECK_EVERY, MAX_TRAV_ITERS - it)):
            _step(boxes, links, tris, w, ar, any_hit)
            it += 1
        live = sync.nonzero_on_host(w.sp > 0)
        n_live = live.shape[0]
        if n_live and n_live <= COMPACT_BELOW * w.sp.shape[0]:
            _write_back(w, hit_t, best_i, best_u, best_v)
            w.keep(live)
    _write_back(w, hit_t, best_i, best_u, best_v)
    stats['steps'] += it
    stats['max_steps'] = max(stats['max_steps'], it)
    stats['lanes_cut'] += n_live
    return hit_t, best_i, best_u, best_v


def _write_back(w: _Lanes, hit_t, best_i, best_u, best_v) -> None:
    if w.ids is None:
        hit_t.copy_(w.hit_t)
        best_i.copy_(w.best_i)
        best_u.copy_(w.best_u)
        best_v.copy_(w.best_v)
        return
    hit_t[w.ids] = w.hit_t
    best_i[w.ids] = w.best_i
    best_u[w.ids] = w.best_u
    best_v[w.ids] = w.best_v

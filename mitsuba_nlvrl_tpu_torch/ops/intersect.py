"""Wavefront ray-scene intersection.

Port of ``mitsuba_nlvrl_tpu/ops/intersect.py``. Triangles go through the
dense sweep of ``ops/cuda/intersect_cuda.py`` (the hand-written kernel on
the card, its plain version on the CPU), or, in a scene with a BVH (from
``types.BVH_MIN_TRIS`` triangles), through ``ops/bvh.traverse`` on the
card and the CPU alike, as the reference does off TPU; the any hit
against the occluder subset stays dense at every size, as in the
reference. Analytic spheres are a small dense test written in torch.

Contract:
  intersect_preliminary -> (t, prim_idx, prim_kind, u, v) nearest hit
  ray_test              -> bool any-hit (shadow rays)
  ray_test_occluders    -> bool any-hit against non-null-BSDF primitives
  compute_si            -> full SurfaceInteraction from a preliminary hit
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.ray import Ray
from ..core.records import SurfaceInteraction
from ..scene.types import BSDF_TYPES
from . import bvh as bvh_mod
from .cuda.intersect_cuda import intersect_tris

KIND_TRI = 0
KIND_SPHERE = 1


class PreliminaryHit(NamedTuple):
    valid: torch.Tensor     # (N,) bool
    t: torch.Tensor         # (N,)
    prim_idx: torch.Tensor  # (N,) int32 index within its kind's array
    kind: torch.Tensor      # (N,) int32 KIND_*
    u: torch.Tensor         # (N,) barycentric / param coords
    v: torch.Tensor


def _sphere_hits(o, d, center, radius):
    """o,d (N,1,3); center (1,S,3); radius (1,S). Returns (t_near, t_far,
    hit)."""
    oc = o - center
    b = m.dot(oc, d)
    c = m.dot(oc, oc) - radius * radius
    disc = b * b - c
    hit = disc >= 0
    sq = m.safe_sqrt(disc)
    return -b - sq, -b + sq, hit


def _tris(tris, ray: Ray, maxt, any_hit: bool, bvh=None):
    """(t, idx, u, v) of the triangles ``tris``: through the BVH when one
    is given, else the dense sweep."""
    if bvh is not None:
        return bvh_mod.traverse(bvh, tris.v0, tris.e1, tris.e2, ray.o, ray.d,
                                ray.mint, maxt, any_hit=any_hit)
    # the integrators' rays are contiguous by construction (Ray.make fills
    # scalar bounds; tests/test_torch_kernel_abi.py checks a render); the
    # kernel's wrapper raises on any that is not
    return intersect_tris(tris.v0, tris.e1, tris.e2, ray.o, ray.d, ray.mint,
                          maxt, any_hit=any_hit)


def intersect_preliminary(scene, ray: Ray, maxt=None) -> PreliminaryHit:
    """Nearest hit over all primitives. ``maxt`` overrides ray.maxt."""
    geo = scene.geo
    N = ray.o.shape[0]
    dev = ray.o.device
    maxt = ray.maxt if maxt is None else maxt
    best_t = torch.full((N,), m.Infinity, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    kind = torch.zeros((N,), dtype=torch.int32, device=dev)

    if geo.v0.shape[0] > 0:
        best_t, best_i, best_u, best_v = _tris(geo, ray, maxt, False,
                                               scene.bvh)

    if geo.sph_center.shape[0] > 0:
        tn, tf, hit = _sphere_hits(ray.o[:, None], ray.d[:, None],
                                   geo.sph_center[None], geo.sph_radius[None])
        tn_ok = hit & (tn >= ray.mint[:, None]) & (tn <= maxt[:, None])
        tf_ok = hit & (tf >= ray.mint[:, None]) & (tf <= maxt[:, None])
        ts = torch.where(tn_ok, tn, torch.where(tf_ok, tf, m.Infinity))
        tj, j = ts.min(dim=1)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_i = torch.where(better, j.to(torch.int32), best_i)
        kind = torch.where(better, KIND_SPHERE, kind)

    valid = torch.isfinite(best_t)
    return PreliminaryHit(valid=valid, t=best_t, prim_idx=best_i, kind=kind,
                          u=best_u, v=best_v)


def _any_hit(scene, ray: Ray, maxt, occluders_only: bool) -> torch.Tensor:
    """Any hit over the scene's primitives, or over those whose BSDF is
    not ``null`` (``occluders_only``): triangles through the kernel on
    the scene's occluder subset (built once in ``scene_from_numpy``), which
    gives exactly the answer of the reference's per-triangle mask; spheres
    keep a mask here. The whole set goes through the scene's BVH where it
    has one; the occluder subset is swept densely at every size."""
    geo = scene.geo
    tris = scene.occluders if occluders_only else geo
    maxt = ray.maxt if maxt is None else maxt
    occluded = torch.zeros((ray.o.shape[0],), dtype=torch.bool,
                           device=ray.o.device)
    if tris.v0.shape[0] > 0:
        t, _, _, _ = _tris(tris, ray, maxt, True,
                           None if occluders_only else scene.bvh)
        occluded = occluded | torch.isfinite(t)
    if geo.sph_center.shape[0] > 0:
        tn, tf, hit = _sphere_hits(ray.o[:, None], ray.d[:, None],
                                   geo.sph_center[None], geo.sph_radius[None])
        ok = hit & (((tn >= ray.mint[:, None]) & (tn <= maxt[:, None]))
                    | ((tf >= ray.mint[:, None]) & (tf <= maxt[:, None])))
        if occluders_only:
            sph_b = scene.shapes.bsdf_idx[geo.sph_shape_idx.long()]
            ok = ok & (scene.bsdfs.type[sph_b.long()]
                       != BSDF_TYPES['null'])[None, :]
        occluded = occluded | ok.any(dim=1)
    return occluded


def _detached(ray: Ray, maxt):
    """The ray and its ``maxt`` override cut from autograd: intersection
    carries no gradient (the reference differentiates throughput weights
    only, never the sampling structure), so the kernel needs no backward
    pass and the plain version records no graph."""
    return (Ray(*(x.detach() for x in ray)),
            None if maxt is None else maxt.detach())


def ray_test(scene, ray: Ray, maxt=None) -> torch.Tensor:
    """Shadow-ray any-hit (a mask: it carries no gradient)."""
    return _any_hit(scene, *_detached(ray, maxt), False)


def ray_test_occluders(scene, ray: Ray, maxt=None) -> torch.Tensor:
    """Any hit against primitives whose BSDF is not ``null``: the shadow
    query of the single-segment NEE path (integrators/volpath.py), which
    passes through pure-null medium boundaries without a surface walk."""
    return _any_hit(scene, *_detached(ray, maxt), True)


def compute_si(scene, ray: Ray, pi: PreliminaryHit) -> SurfaceInteraction:
    """Fill a full SurfaceInteraction from a preliminary hit."""
    geo = scene.geo
    N = ray.o.shape[0]
    dev = ray.o.device
    idx = torch.clamp(pi.prim_idx, min=0).long()
    is_tri = (pi.kind == KIND_TRI) & pi.valid

    if geo.v0.shape[0] > 0:
        te1, te2 = geo.e1[idx], geo.e2[idx]
        n0, n1, n2 = geo.n0[idx], geo.n1[idx], geo.n2[idx]
        uv0, uv1, uv2 = geo.uv0[idx], geo.uv1[idx], geo.uv2[idx]
        shape_tri = geo.shape_idx[idx]
        gn_tri = m.normalize(m.cross(te1, te2))
        w = 1.0 - pi.u - pi.v
        ns_tri = m.normalize(w[:, None] * n0 + pi.u[:, None] * n1
                             + pi.v[:, None] * n2)
        uv_tri = (w[:, None] * uv0 + pi.u[:, None] * uv1
                  + pi.v[:, None] * uv2)
    else:
        gn_tri = ns_tri = torch.zeros((N, 3), device=dev)
        uv_tri = torch.zeros((N, 2), device=dev)
        shape_tri = torch.zeros((N,), dtype=torch.int32, device=dev)

    # clamp miss-t to 0 before evaluating positions (inf * 0 is NaN)
    t_safe = torch.where(pi.valid, pi.t, 0.0)
    p = ray.at(t_safe)

    if geo.sph_center.shape[0] > 0:
        sidx = torch.clamp(idx, 0, geo.sph_center.shape[0] - 1)
        gn_sph = m.normalize(p - geo.sph_center[sidx])
        shape_sph = geo.sph_shape_idx[sidx]
        theta = m.safe_acos(gn_sph[:, 2])
        phi = torch.atan2(gn_sph[:, 1], gn_sph[:, 0])
        uv_sph = torch.stack([phi * m.InvTwoPi + 0.5, theta * m.InvPi], -1)
        gn = torch.where(is_tri[:, None], gn_tri, gn_sph)
        ns = torch.where(is_tri[:, None], ns_tri, gn_sph)
        uv = torch.where(is_tri[:, None], uv_tri, uv_sph)
        shape_idx = torch.where(is_tri, shape_tri, shape_sph)
    else:
        gn, ns, uv, shape_idx = gn_tri, ns_tri, uv_tri, shape_tri

    sh_frame = Frame.from_normal(ns)
    wi_local = sh_frame.to_local(-ray.d)

    shape_idx = torch.where(pi.valid, shape_idx, -1)
    safe_shape = torch.clamp(shape_idx, min=0).long()
    st = scene.shapes
    bsdf_i = st.bsdf_idx[safe_shape]
    emitter_i = st.emitter_idx[safe_shape]
    int_m = st.int_medium[safe_shape]
    ext_m = st.ext_medium[safe_shape]
    return SurfaceInteraction(
        valid=pi.valid,
        t=torch.where(pi.valid, pi.t, m.Infinity),
        p=p, n=gn, sh_frame=sh_frame, uv=uv, wi=wi_local,
        prim_index=pi.prim_idx, shape_idx=shape_idx,
        bsdf_idx=torch.where(pi.valid, bsdf_i, 0),
        emitter_idx=torch.where(pi.valid, emitter_i, -1),
        int_medium=torch.where(pi.valid, int_m, -1),
        ext_medium=torch.where(pi.valid, ext_m, -1))


def ray_intersect(scene, ray: Ray, maxt=None) -> SurfaceInteraction:
    """Closest-hit intersection, detached from autograd as in the
    reference: the rays going in are detached, so the interaction coming
    out carries no gradient (shape gradients are out of scope; a
    parameter-dependent origin, such as a sampled medium collision,
    would otherwise push cotangents into masked lanes)."""
    ray, maxt = _detached(ray, maxt)
    return compute_si(scene, ray, intersect_preliminary(scene, ray, maxt))

"""The ``aov``, ``moment`` and ``stokes`` integrators.

Port of ``mitsuba_nlvrl_tpu/integrators/aov.py``:
  * ``aov`` renders a geometric feature (depth, sh_normal, geo_normal,
    position, uv, prim_index, shape_index) named by the first entry of
    the ``aovs`` property (e.g. "nn:sh_normal"), packed into RGB;
  * ``moment`` renders the nested integrator's radiance squared (beside a
    plain render it gives the per-pixel variance);
  * ``stokes`` runs the polarized variant of the nested ``path``
    integrator and emits the Stokes component its ``component`` property
    names (0 = S0 radiance, 1-3 = S1, S2, S3), rotated into the sensor's
    frame. Around another integrator it renders that integrator
    unpolarized: S0 the radiance, S1-S3 zero.
The nested integrator is the ``integrator`` property, a type name or a
frozen description (``scene/types.nested_meta``).
"""
from __future__ import annotations

import torch

from ..core.ray import Ray
from ..core.rng import Sampler
from ..ops import intersect as isect
from ..scene.types import nested_meta


def sample_aov(scene, meta, sampler: Sampler, ray: Ray, active=None,
               diff: bool = False, aux=None):
    N = ray.o.shape[0]
    spec = meta.iprop('aovs', 'dd.y:depth')
    kind = spec.split(':')[-1].strip()
    si = isect.ray_intersect(scene, ray)
    hit = si.valid[:, None]
    if kind == 'depth':
        out = torch.where(si.valid, si.t, 0.0)[:, None].expand(N, 3)
    elif kind in ('sh_normal', 'nn'):
        out = torch.where(hit, si.sh_frame.n, 0.0)
    elif kind in ('geo_normal', 'ng'):
        out = torch.where(hit, si.n, 0.0)
    elif kind in ('position', 'p'):
        out = torch.where(hit, si.p, 0.0)
    elif kind == 'uv':
        out = torch.cat([si.uv, torch.zeros((N, 1), device=si.uv.device)],
                        dim=-1)
        out = torch.where(hit, out, 0.0)
    elif kind in ('prim_index', 'shape_index'):
        idx = si.prim_index if kind == 'prim_index' else si.shape_idx
        out = idx[:, None].to(torch.float32).expand(N, 3)
    else:
        raise KeyError(f"unknown aov '{kind}'")
    return out, si.valid, sampler


def sample_moment(scene, meta, sampler: Sampler, ray: Ray, active=None,
                  diff: bool = False, aux=None):
    from . import get_integrator
    meta2 = nested_meta(meta)
    L, valid, sampler = get_integrator(meta2.integrator)(
        scene, meta2, sampler, ray, active, diff=diff, aux=aux)
    return L * L, valid, sampler


def sample_stokes(scene, meta, sampler: Sampler, ray: Ray, active=None,
                  diff: bool = False, aux=None):
    from . import get_integrator
    meta2 = nested_meta(meta)
    comp = int(meta.iprop('component', 0))
    if meta2.integrator == 'path':
        if meta2.spectral:
            from . import path_spectral_polarized as spp
            stokes, valid, sampler = spp.sample_full(
                scene, meta2, sampler, ray, active, diff=diff, aux=aux)
        else:
            from . import path_polarized
            stokes, valid, sampler = path_polarized.sample_full(
                scene, meta2, sampler, ray, active, diff=diff, aux=aux)
        return stokes[:, :, comp], valid, sampler
    L, valid, sampler = get_integrator(meta2.integrator)(
        scene, meta2, sampler, ray, active, diff=diff, aux=aux)
    if comp != 0:
        L = torch.zeros_like(L)
    return L, valid, sampler

"""SoA scene representation.

Port of ``mitsuba_nlvrl_tpu/scene/types.py``: the scene is flattened at
build time into structure-of-arrays tensors indexed by integer type codes,
and per-lane virtual dispatch becomes masked evaluation over the few types
a scene uses (``SceneMeta`` records which). The type tables keep the
reference's codes, so packed parameter rows mean the same in both
packages. This slice holds the tables the ``path`` integrator reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import torch

from ..core.transform import Transform

# --- type codes (same as the reference package) ------------------------------

BSDF_TYPES = {
    'diffuse': 0, 'conductor': 1, 'dielectric': 2, 'thindielectric': 3,
    'null': 4, 'roughconductor': 5, 'roughdielectric': 6, 'plastic': 7,
    'roughplastic': 8, 'blendbsdf': 9, 'mask': 10, 'twosided': 11,
    'normalmap': 12, 'bumpmap': 13, 'polarizer': 14, 'measured': 15,
    'retarder': 16, 'circular': 17, 'pplastic': 18,
    'measured_polarized': 19,
}

EMITTER_TYPES = {
    'area': 0, 'point': 1, 'constant': 2, 'directional': 3, 'spot': 4,
    'envmap': 5, 'projector': 6,
}

SENSOR_TYPES = {'perspective': 0, 'thinlens': 1, 'radiancemeter': 2,
                'irradiancemeter': 3}

RFILTER_TYPES = {'box': 0, 'tent': 1, 'gaussian': 2, 'mitchell': 3,
                 'catmullrom': 4, 'lanczos': 5}

# BSDF flag bits (analog of reference BSDFFlags)
F_DELTA = 1
F_NULL = 2
F_TRANSMISSION = 4
F_SMOOTH = 8          # has a non-delta lobe
F_TWOSIDED = 16
F_MASK = 32

BSDF_NPARAM = 20
EMITTER_NPARAM = 28

# What this slice of the port renders; anything else raises
# NotImplementedError naming the ROADMAP item that brings it.
SLICE_SHAPES = ('rectangle', 'cube', 'sphere')
SLICE_BSDFS = ('diffuse', 'conductor', 'dielectric')
SLICE_EMITTERS = ('area', 'point', 'constant')
SLICE_SENSORS = ('perspective',)
SLICE_SAMPLERS = ('independent',)
SLICE_INTEGRATORS = ('path',)


def not_in_slice(what: str, roadmap: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, {roadmap})")


class Geometry(NamedTuple):
    """All triangles in world space with Möller-Trumbore precomputation
    (v0, e1 = v1 - v0, e2 = v2 - v0), plus analytic spheres."""
    v0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3)
    e2: torch.Tensor        # (T, 3)
    n0: torch.Tensor        # (T, 3) shading normals at corners
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    shape_idx: torch.Tensor  # (T,) int32
    sph_center: torch.Tensor     # (S, 3)
    sph_radius: torch.Tensor     # (S,)
    sph_shape_idx: torch.Tensor  # (S,) int32


class ShapeTable(NamedTuple):
    bsdf_idx: torch.Tensor        # (Sh,) int32
    emitter_idx: torch.Tensor     # (Sh,) int32, -1 = not emissive


class BSDFTable(NamedTuple):
    type: torch.Tensor      # (B,) int32
    flags: torch.Tensor     # (B,) int32
    params: torch.Tensor    # (B, BSDF_NPARAM) float32


class EmitterTable(NamedTuple):
    type: torch.Tensor       # (E,) int32
    params: torch.Tensor     # (E, EMITTER_NPARAM) float32
    shape_idx: torch.Tensor  # (E,) int32; -1 for shapeless emitters
    # area-emitter triangle sampling: concatenated per-emitter tables
    tri_offset: torch.Tensor  # (E,) int32 into em_tri arrays
    tri_count: torch.Tensor   # (E,) int32
    em_tri_idx: torch.Tensor  # (TE,) int32 triangle ids
    em_tri_cdf: torch.Tensor  # (TE,) float32, per-emitter normalized cdf
    em_area: torch.Tensor     # (E,) float32 total emitter area


class SensorData(NamedTuple):
    to_world: Transform
    tan_fov_x: torch.Tensor   # () tan(fov_x / 2)
    tan_fov_y: torch.Tensor   # ()
    near_clip: torch.Tensor
    far_clip: torch.Tensor
    aperture_radius: torch.Tensor
    focus_distance: torch.Tensor


class SceneData(NamedTuple):
    geo: Geometry
    shapes: ShapeTable
    bsdfs: BSDFTable
    emitters: EmitterTable
    sensor: SensorData
    bbox_lo: torch.Tensor     # (3,)
    bbox_hi: torch.Tensor     # (3,)
    bsphere_c: torch.Tensor   # (3,)
    bsphere_r: torch.Tensor   # ()

    @property
    def device(self) -> torch.device:
        return self.geo.v0.device


@dataclass(frozen=True)
class FilmMeta:
    width: int = 256
    height: int = 256
    rfilter: str = 'gaussian'


@dataclass(frozen=True)
class SceneMeta:
    """Static scene facts that choose code paths."""
    n_tris: int = 0
    n_spheres: int = 0
    n_shapes: int = 0
    n_bsdfs: int = 0
    n_emitters: int = 0
    bsdf_types: Tuple[int, ...] = ()          # distinct codes present
    emitter_types: Tuple[int, ...] = ()
    sensor_type: int = 0
    film: FilmMeta = field(default_factory=FilmMeta)
    sampler: str = 'independent'
    spp: int = 16
    integrator: str = 'path'
    integrator_props: Tuple[Tuple[str, object], ...] = ()

    def iprop(self, name, default=None):
        for k, v in self.integrator_props:
            if k == name:
                return v
        return default


def check_meta(meta: SceneMeta) -> None:
    """Raise NotImplementedError for what this slice does not render."""
    bsdf_names = {v: k for k, v in BSDF_TYPES.items()}
    for code in meta.bsdf_types:
        if bsdf_names.get(code) not in SLICE_BSDFS:
            raise not_in_slice(f"bsdf type '{bsdf_names.get(code)}'",
                               "item 7 (materials)")
    em_names = {v: k for k, v in EMITTER_TYPES.items()}
    for code in meta.emitter_types:
        if em_names.get(code) not in SLICE_EMITTERS:
            raise not_in_slice(f"emitter type '{em_names.get(code)}'",
                               "item 7 (lights)")
    sen_names = {v: k for k, v in SENSOR_TYPES.items()}
    if sen_names.get(meta.sensor_type) not in SLICE_SENSORS:
        raise not_in_slice(f"sensor type '{sen_names.get(meta.sensor_type)}'",
                           "item 5 (camera and film)")
    if meta.sampler not in SLICE_SAMPLERS:
        raise not_in_slice(f"sampler '{meta.sampler}'", "item 3 (sampling)")
    if meta.integrator not in SLICE_INTEGRATORS:
        raise not_in_slice(f"integrator '{meta.integrator}'",
                           "items 7-11 (integrators)")
    if meta.film.rfilter not in RFILTER_TYPES:
        raise ValueError(f"unknown reconstruction filter "
                         f"'{meta.film.rfilter}'")

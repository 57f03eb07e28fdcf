"""SoA scene representation.

Port of ``mitsuba_nlvrl_tpu/scene/types.py``: the scene is flattened at
build time into structure-of-arrays tensors indexed by integer type codes,
and per-lane virtual dispatch becomes masked evaluation over the few types
a scene uses (``SceneMeta`` records which). The type tables keep the
reference's codes, so packed parameter rows mean the same in both
packages. The tables hold what the ``path``, ``direct``, ``depth``,
``volpath``, ``volpathmis``, ``vrl`` and ``photonmapper`` integrators
read, textures and the environment map's warp among them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

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

MEDIUM_TYPES = {'homogeneous': 0, 'heterogeneous': 1, 'nonlinear': 2}

PHASE_TYPES = {'isotropic': 0, 'hg': 1}

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

# scenes with at least this many triangles get a BVH, their triangles
# reordered by it (the reference's threshold)
BVH_MIN_TRIS = 1024

BSDF_NPARAM = 20
EMITTER_NPARAM = 28
MEDIUM_NPARAM = 28

# medium param layout offsets
M_SIGMA_T = 0       # [0:3]
M_ALBEDO = 3        # [3:6]
M_SCALE = 6
M_PHASE_G = 7
M_BBOX_MIN = 8      # [8:11]
M_BBOX_MAX = 11     # [11:14]
M_MAJORANT = 14     # [14:17]
# nonlinear medium: IOR profile and voxel resolution of its IOR grid
M_NL_TOP_IOR = 17
M_NL_BOT_IOR = 18
M_NL_RES = 19       # [19:22] voxel resolution (as float)
M_NL_FROM_BOTTOM = 22

TEXTURE_TYPES = {'bitmap': 0, 'checkerboard': 1, 'constant': 2,
                 'grid3d': 3, 'constant3d': 4, 'mesh_attribute': 5}
TEX_NPARAM = 24

# What the port renders; anything else raises NotImplementedError naming
# the ROADMAP item that brings it. ``shapegroup`` and ``instance`` are
# flattened by the builder; ``mask`` packs as its nested BSDF's row with
# ``F_MASK``.
SLICE_SHAPES = ('rectangle', 'cube', 'sphere', 'disk', 'cylinder', 'obj',
                'ply', 'serialized', 'blender', 'mesh')
SLICE_BSDFS = ('diffuse', 'conductor', 'dielectric', 'thindielectric',
               'null', 'roughconductor', 'roughdielectric', 'plastic',
               'roughplastic', 'pplastic', 'twosided', 'mask', 'blendbsdf',
               'normalmap', 'bumpmap', 'polarizer', 'retarder', 'circular',
               'measured', 'measured_polarized')
# integrators that wrap another (its ``integrator`` property)
WRAPPER_INTEGRATORS = ('aov', 'moment', 'stokes')
SLICE_MEDIA = ('homogeneous', 'heterogeneous', 'nonlinear')
SLICE_PHASES = ('isotropic', 'hg')


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
    # per-corner colours, present only when a mesh carries them (the
    # mesh_attribute textures read them)
    c0: object = ()              # (T, 3)
    c1: object = ()
    c2: object = ()


class ShapeTable(NamedTuple):
    bsdf_idx: torch.Tensor        # (Sh,) int32
    emitter_idx: torch.Tensor     # (Sh,) int32, -1 = not emissive
    int_medium: torch.Tensor      # (Sh,) int32, -1 = none
    ext_medium: torch.Tensor      # (Sh,) int32, -1 = none


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
    # the environment map (at most one a scene; (1, 1, 3) zeros without):
    # radiance texels, the Hierarchical2D warp of luminance * sin(theta)
    # (core/distr2d.py), the emitter-to-world transform and the scale
    env_map: torch.Tensor     # (He, We, 3)
    env_warp: object
    env_to_world: Transform
    env_scale: torch.Tensor   # ()
    # each emitter's true spectrum for the spectral variant
    # (emitter.SPEC_*): its kind, blackbody temperature or table row, and
    # scale; the tabulated SPDs on the CIE grid
    spec_kind: torch.Tensor   # (E,) int32
    spec_param: torch.Tensor  # (E,) float32
    spec_scale: torch.Tensor  # (E,) float32
    spec_table: torch.Tensor  # (max(1, n_spd), 95) float32


class MediumTable(NamedTuple):
    """Participating media: one packed parameter row per medium (at least
    one row, so per-lane gathers stay well-formed in medium-free scenes)
    and the scene's one density grid with its derived copies."""
    type: torch.Tensor           # (M,) int32 MEDIUM_TYPES code
    phase_type: torch.Tensor     # (M,) int32 PHASE_TYPES code
    params: torch.Tensor         # (M, MEDIUM_NPARAM) float32
    grid_sigma_t: torch.Tensor   # (Dz, Dy, Dx) float32; (1, 1, 1) unused
    # supervoxel block max (dilated) and min (eroded) of grid_sigma_t:
    # the local majorants and controls of the tracking walks
    grid_sup: torch.Tensor       # (Sz, Sy, Sx); (1, 1, 1) ones unused
    grid_sup_min: torch.Tensor   # (Sz, Sy, Sx); (1, 1, 1) zeros unused
    # the nonlinear medium's IOR voxel grid (one a scene), flat in the
    # reference's (x * ry + y) * rz + z order; (1,) ones unused
    nl_ior: torch.Tensor
    nl_medium: torch.Tensor      # () int32 the nonlinear medium (-1 none)
    # corner-packed rows (Dz*Dy*Dx, 10): the 8 trilinear corners of each
    # voxel, its block's bound (slot 8) and control or leap distance
    # (slot 9); None when the grid is absent or too large to copy
    grid_sigma_p8: Optional[torch.Tensor] = None
    # a heterogeneous medium's albedo gridvolume, (Az, Ay, Ax, 3): carried
    # as the reference carries it, and read by nothing (its row's albedo
    # is one; ROADMAP C)
    grid_albedo: Optional[torch.Tensor] = None


class TextureTable(NamedTuple):
    """Textures of BSDF parameters, the projector's slide and the wrapper
    BSDFs (one row a texture, ``texture/__init__.py`` gives the layout).
    Bitmaps are stacked padded to the largest; grid3d volumes likewise."""
    type: torch.Tensor       # (Tx,) int32
    params: torch.Tensor     # (Tx, TEX_NPARAM)
    data: torch.Tensor       # (Tb, Hmax, Wmax, 3) float32
    size: torch.Tensor       # (Tx, 2) int32 (H, W); 0 for other rows
    vol: object = ()         # (Tv, Dm, Hm, Wm, 3) float32
    vol_size: object = ()    # (Tx, 3) int32 (D, H, W); 1 for other rows


class Occluders(NamedTuple):
    """The triangles whose BSDF is not ``null``: the any-hit set of the
    single-segment NEE shadow query. The same tensors as ``Geometry``'s
    when no triangle has a null BSDF."""
    v0: torch.Tensor        # (To, 3)
    e1: torch.Tensor
    e2: torch.Tensor


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
    media: MediumTable
    occluders: Occluders
    textures: TextureTable
    sensor: SensorData
    bbox_lo: torch.Tensor     # (3,)
    bbox_hi: torch.Tensor     # (3,)
    bsphere_c: torch.Tensor   # (3,)
    bsphere_r: torch.Tensor   # ()
    # the BVH over the (reordered) triangles of a scene of BVH_MIN_TRIS or
    # more (ops/bvh.BVHArrays); None below
    bvh: Optional[object] = None
    # the named conductors' eta/k curves on the CIE grid, (C, 2, 95), that
    # BSDF slot 13 names (id + 1) for the spectral variant; () when absent
    conductor_spd: object = ()
    # the measured BSDFs' warps, one bsdf.measured.MeasuredData a material
    # (the row's slot 0 names it), and the measured polarized grids, one
    # bsdf.measured_pol.MeasuredPolData a material
    measured: Tuple = ()
    measured_pol: Tuple = ()

    @property
    def device(self) -> torch.device:
        return self.geo.v0.device

    @property
    def dtype(self) -> torch.dtype:
        """The scene's float type: float64 under the double variant."""
        return self.geo.v0.dtype


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
    n_media: int = 0
    bsdf_types: Tuple[int, ...] = ()          # distinct codes present
    emitter_types: Tuple[int, ...] = ()
    medium_types: Tuple[int, ...] = ()        # per-medium-slot type codes
    phase_types: Tuple[int, ...] = ()         # distinct phase codes present
    sensor_type: int = 0
    film: FilmMeta = field(default_factory=FilmMeta)
    sampler: str = 'independent'
    spp: int = 16
    integrator: str = 'path'
    integrator_props: Tuple[Tuple[str, object], ...] = ()
    has_media: bool = False
    has_bvh: bool = False
    has_textures: bool = False
    has_3d_textures: bool = False    # grid3d rows (eval needs the hit point)
    has_attr_textures: bool = False  # mesh_attribute rows and corner colours
    has_param_textures: bool = False  # alpha, specular, plastic diffuse or
    #                                   opacity textures
    camera_medium: int = -1    # medium the camera starts in (-1 vacuum)
    spectral: bool = False     # hero-wavelength transport (path family)
    has_conductor_spd: bool = False  # tabulated conductor eta/k curves
    # one bsdf.measured.MeasuredMeta (isotropic, jacobian, reduction) a
    # measured material
    measured_meta: Tuple = ()

    def iprop(self, name, default=None):
        for k, v in self.integrator_props:
            if k == name:
                return v
        return default


def nested_meta(meta: SceneMeta, default: str = 'path') -> SceneMeta:
    """The meta of the integrator a wrapper integrator holds: its
    ``integrator`` property, a type name or a frozen description (sorted
    (key, value) tuples, as the builder freezes nested dicts)."""
    v = meta.iprop('integrator', default)
    if isinstance(v, str):
        name, props = v, ()
    elif isinstance(v, tuple):
        d = dict(v)
        name = d.pop('type', default)
        props = tuple(sorted(d.items()))
    else:
        name, props = default, ()
    return dataclasses.replace(meta, integrator=name, integrator_props=props)


def unwrap(meta: SceneMeta, depth: int = 4) -> SceneMeta:
    """The meta of the innermost integrator under up to ``depth``
    wrappers (the reference's preprocess unwraps as far, so a wrapped
    two-pass integrator still shoots its photons)."""
    for _ in range(depth):
        if meta.integrator not in WRAPPER_INTEGRATORS:
            break
        meta = nested_meta(meta)
    return meta


def check_meta(meta: SceneMeta) -> None:
    """Raise NotImplementedError for what this slice does not render."""
    bsdf_names = {v: k for k, v in BSDF_TYPES.items()}
    for code in meta.bsdf_types:
        if bsdf_names.get(code) not in SLICE_BSDFS:
            raise ValueError(f"unknown bsdf type code {code}")
    for code in meta.emitter_types:
        if code not in EMITTER_TYPES.values():
            raise ValueError(f"unknown emitter type code {code}")
    if meta.sensor_type not in SENSOR_TYPES.values():
        raise ValueError(f"unknown sensor type code {meta.sensor_type}")
    med_names = {v: k for k, v in MEDIUM_TYPES.items()}
    for code in meta.medium_types:
        if med_names.get(code) not in SLICE_MEDIA:
            raise ValueError(f"unknown medium type code {code}")
    ph_names = {v: k for k, v in PHASE_TYPES.items()}
    for code in meta.phase_types:
        if ph_names.get(code) not in SLICE_PHASES:
            raise ValueError(f"unknown phase function code {code}")
    # the registry: the built-in integrators and any registered since
    from ..integrators import get_integrator
    inner = unwrap(meta)
    for name in (meta.integrator, inner.integrator):
        get_integrator(name)    # KeyError for a name it does not hold
    if meta.film.rfilter not in RFILTER_TYPES:
        raise ValueError(f"unknown reconstruction filter "
                         f"'{meta.film.rfilter}'")

"""Scene builder: description dicts -> SoA tensors.

Port of ``mitsuba_nlvrl_tpu/scene/builder.py`` for the types this slice
renders (``types.SLICE_*``). A scene description (nested dicts, as
``testing/scenes.py`` makes them) is flattened on the host into numpy
arrays keyed like the reference's ``SceneData`` fields ("geo.v0",
"bsdfs.params", "sensor.to_world.m", ...), and ``scene_from_numpy`` turns
those into tensors on the render device. The reference's own build goes
through the same function, which is how the tests render the very same
arrays in both packages.

All geometry is pre-transformed to world space; rectangles and cubes
become exact triangle pairs, disks and cylinders tessellate, OBJ, PLY,
Mitsuba .serialized and Blender meshes load through ``mesh_io``; spheres
stay analytic unless emissive (area emitters sample triangles, so an
emissive sphere tessellates). From ``BVH_MIN_TRIS`` triangles the builder
makes the reference's BVH (``ops/bvh.build``), reorders the triangle
tables by it and remaps the emitters' triangle ids, as the reference does;
below it the triangles keep their input order and the dense kernel
intersects them. The reference's TPU cluster arrays are not built.

Shapes may bound participating media (``interior``/``exterior``); a
medium-only shape gets a ``null`` BSDF. Homogeneous, heterogeneous (one
density grid a scene) and nonlinear (one IOR grid a scene) media are
packed as the reference packs them, with the density grid's supervoxel
bounds and corner-packed rows and the voxelised IOR grid derived here.
"""
from __future__ import annotations

import os
from dataclasses import fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.transform import Transform
from .types import (SceneData, SceneMeta, FilmMeta, Geometry, ShapeTable,
                    BSDFTable, EmitterTable, MediumTable, Occluders,
                    SensorData, BSDF_NPARAM, BSDF_TYPES, EMITTER_NPARAM,
                    EMITTER_TYPES, MEDIUM_NPARAM, MEDIUM_TYPES, PHASE_TYPES,
                    M_SIGMA_T, M_ALBEDO, M_SCALE, M_PHASE_G, M_BBOX_MIN,
                    M_BBOX_MAX, M_MAJORANT, M_NL_TOP_IOR, M_NL_BOT_IOR,
                    M_NL_RES, M_NL_FROM_BOTTOM, SLICE_MEDIA, SLICE_PHASES,
                    BVH_MIN_TRIS, F_MASK,
                    SLICE_SHAPES, check_meta, not_in_slice)
from .mesh_io import (MeshData, compute_vertex_normals, load_blender,
                      load_obj, load_ply, load_serialized)
from .vol_io import load_vol
from ..ops import bvh as bvh_mod
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..sensor import build_sensor


def _rectangle_mesh() -> MeshData:
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshData(v, f, n, uv)


def _cube_mesh() -> MeshData:
    corners = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1)
                        for x in (-1, 1)], np.float32)
    faces = []
    # outward winding (CCW seen from outside): -z, +z, -y, +y, -x, +x
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
             (0, 4, 6, 2), (1, 3, 7, 5)]
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return MeshData(corners, np.asarray(faces, np.int32), None, None)


def icosphere_mesh(subdiv: int = 3) -> MeshData:
    """Unit icosphere (emissive spheres tessellate into it)."""
    phi = (1.0 + 5 ** 0.5) / 2.0
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(subdiv):
        mid = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                p = p / np.linalg.norm(p)
                mid[key] = len(verts)
                verts.append(p)
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    vf = v.astype(np.float32)
    return MeshData(vf, f.astype(np.int32), vf.copy(), None)


def _disk_mesh(segments: int = 64) -> MeshData:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(segments)], -1)
    v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    f = np.asarray([[0, 1 + i, 1 + (i + 1) % segments]
                    for i in range(segments)], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (segments + 1, 1))
    return MeshData(v, f, n, None)


def _cylinder_mesh(radius: float, p0, p1, segments: int = 64) -> MeshData:
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    axis = axis / np.linalg.norm(axis)
    a = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(axis, a)
    u /= np.linalg.norm(u)
    w = np.cross(axis, u)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.outer(np.cos(ang), u) + np.outer(np.sin(ang), w)
    v = np.concatenate([p0 + radius * ring, p1 + radius * ring]
                       ).astype(np.float32)
    n = np.concatenate([ring, ring]).astype(np.float32)
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f += [[i, j, segments + i], [j, segments + j, segments + i]]
    return MeshData(v, np.asarray(f, np.int32), n, None)


def _load_shape_mesh(sh: dict) -> Optional[MeshData]:
    """The shape's mesh in object space, or None for an analytic sphere."""
    t = sh['type']
    if t not in SLICE_SHAPES:
        raise not_in_slice(f"shape type '{t}'", "item 4 (scene front-end)")
    if t == 'mesh':
        return sh['mesh']
    if t == 'sphere':
        if sh.get('emitter') is None:
            return None   # analytic
        mesh = icosphere_mesh()
        c = np.asarray(sh.get('center', (0, 0, 0)), np.float32)
        r = float(sh.get('radius', 1.0))
        return MeshData(mesh.vertices * r + c, mesh.faces, mesh.normals, None)
    if t == 'obj':
        mesh = load_obj(sh['filename'])
    elif t == 'ply':
        mesh = load_ply(sh['filename'])
    elif t == 'serialized':
        mesh = load_serialized(sh['filename'], int(sh.get('shape_index', 0)))
    elif t == 'blender':
        mesh = load_blender(sh)
    elif t == 'rectangle':
        mesh = _rectangle_mesh()
    elif t == 'cube':
        mesh = _cube_mesh()
    elif t == 'disk':
        mesh = _disk_mesh()
    else:
        mesh = _cylinder_mesh(float(sh.get('radius', 1.0)),
                              sh.get('p0', (0, 0, 0)), sh.get('p1', (0, 0, 1)))
    if sh.get('face_normals', False):
        mesh = mesh._replace(normals=None)
    return mesh


_NULL_BSDF = {'type': 'null'}

# duplicate the density grid 8x only up to this size (4M voxels -> 160 MB)
_PACK_MAX_VOXELS = 1 << 22

# supervoxel block edge (voxels), the reference's shipped default
_SUP_K = 8


def _corner_pack(grid: np.ndarray) -> np.ndarray:
    """Corner-packed grid: row (z*Dy+y)*Dx+x holds the 8 trilinear corners
    of voxel (z,y,x), order dz*4+dy*2+dx, edge-clamped, plus (slot 8) the
    dilated supervoxel block max and (slot 9) the eroded block min of the
    voxel's block, so one row gather fetches a whole trilinear footprint
    and the local majorant and control of the point's block.

    The walk addresses a row by the probe's trilinear base voxel
    v = floor(rel*D - 0.5), and the probe is the midpoint of a DDA
    interval inside one block. For v interior to its block the
    1-voxel-dilated block window bounds every footprint of the interval;
    when v is the last voxel of its block on some axis the interval lies
    in the next block there, so those rows take a [lo-1, hi+2] window.

    For rows whose slot-8 bound is zero (vacuum), slot 9 holds -D instead:
    D is the Chebyshev distance in blocks from the voxel's block (or the
    block of v+1 on any axis) to the nearest block whose widest-window max
    is nonzero. Every block nearer than D is empty, so a crossing walk
    leaps over them in one event (decoded in ``medium._majorant_walk``)."""
    sup_k = _SUP_K
    Dz, Dy, Dx = grid.shape
    zi = np.minimum(np.arange(Dz) + 1, Dz - 1)
    yi = np.minimum(np.arange(Dy) + 1, Dy - 1)
    xi = np.minimum(np.arange(Dx) + 1, Dx - 1)
    out = np.empty((Dz, Dy, Dx, 10), np.float32)
    for k in range(8):
        dz, dy, dx = (k >> 2) & 1, (k >> 1) & 1, k & 1
        g = grid
        if dz:
            g = g[zi]
        if dy:
            g = g[:, yi]
        if dx:
            g = g[:, :, xi]
        out[..., k] = g
    supA = _supervoxel_max(grid)
    supA_min = _supervoxel_min(grid)
    supB = _supervoxel_max(grid, dilate_hi=2)
    supB_min = _supervoxel_min(grid, dilate_hi=2)
    bz = np.arange(Dz) // sup_k
    by = np.arange(Dy) // sup_k
    bx = np.arange(Dx) // sup_k

    def last_of_block(D):
        v = np.arange(D)
        return ((v % sup_k) == sup_k - 1) | (v == D - 1)

    bnd = (last_of_block(Dz)[:, None, None]
           | last_of_block(Dy)[None, :, None]
           | last_of_block(Dx)[None, None, :])
    out[..., 8] = np.where(bnd, supB[bz][:, by][:, :, bx],
                           supA[bz][:, by][:, :, bx])
    out[..., 9] = np.where(bnd, supB_min[bz][:, by][:, :, bx],
                           supA_min[bz][:, by][:, :, bx])
    # leap distances: a distance field over the occupied blocks
    occ = supB > 0.0
    Sz, Sy, Sx = occ.shape

    def _dilate1(mask):
        p = np.pad(mask, 1, mode='constant')
        acc = np.zeros_like(mask)
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    acc |= p[dz:dz + Sz, dy:dy + Sy, dx:dx + Sx]
        return acc

    Dfield = np.zeros(occ.shape, np.float32)
    cur = occ.copy()
    dist = 0
    while not cur.all() and dist < 126:
        dist += 1
        nxt = _dilate1(cur)
        Dfield[nxt & ~cur] = dist
        cur = nxt
    if not cur.all():
        Dfield[~cur] = 127.0
    vac = out[..., 8] <= 0.0
    bzh = np.minimum(np.arange(Dz) + 1, Dz - 1) // sup_k
    byh = np.minimum(np.arange(Dy) + 1, Dy - 1) // sup_k
    bxh = np.minimum(np.arange(Dx) + 1, Dx - 1) // sup_k
    Dsafe = np.full(grid.shape, np.inf, np.float32)
    for az in (bz, bzh):
        for ay in (by, byh):
            for ax in (bx, bxh):
                Dsafe = np.minimum(Dsafe, Dfield[az][:, ay][:, :, ax])
    out[..., 9] = np.where(vac, -Dsafe, out[..., 9])
    return out.reshape(-1, 10)


def _supervoxel_min(grid: np.ndarray, dilate: int = 1,
                    dilate_hi: Optional[int] = None) -> np.ndarray:
    """Block-min density over _SUP_K^3 supervoxels, eroded by ``dilate``
    voxels on the low side and ``dilate_hi`` (default: the same) on the
    high side of every axis: the residual-ratio-tracking control."""
    return _supervoxel_reduce(grid, dilate, dilate_hi, np.min)


def _supervoxel_max(grid: np.ndarray, dilate: int = 1,
                    dilate_hi: Optional[int] = None) -> np.ndarray:
    """Block-max density over _SUP_K^3 supervoxels, dilated by ``dilate``
    voxels on the low side and ``dilate_hi`` (default: the same) on the
    high side of every axis, so a trilinear tap whose footprint straddles
    a block border is still bounded by its block's majorant."""
    return _supervoxel_reduce(grid, dilate, dilate_hi, np.max)


def _supervoxel_reduce(grid, dilate, dilate_hi, op):
    k = _SUP_K
    if dilate_hi is None:
        dilate_hi = dilate
    Dz, Dy, Dx = grid.shape
    Sz, Sy, Sx = (max(1, -(-Dz // k)), max(1, -(-Dy // k)),
                  max(1, -(-Dx // k)))
    pad = max(dilate, dilate_hi)
    gp = np.pad(grid, pad, mode='edge')
    sup = np.zeros((Sz, Sy, Sx), np.float32)
    a0 = pad - dilate                   # window start offset into gp
    w = dilate + k + dilate_hi          # window width per axis
    for bz in range(Sz):
        for by in range(Sy):
            for bx in range(Sx):
                blk = gp[bz * k + a0:bz * k + a0 + w,
                         by * k + a0:by * k + a0 + w,
                         bx * k + a0:bx * k + a0 + w]
                sup[bz, by, bx] = op(blk)
    return sup


def _rgb_of(props: dict, key: str, default):
    """An RGB medium parameter as (3,) float32; None for a texture dict."""
    v = props.get(key, default)
    if isinstance(v, dict):
        return None
    if isinstance(v, (int, float)):
        return np.full(3, float(v), np.float32)
    return np.asarray([float(x) for x in v], np.float32)


def _nl_ior_grid(props: dict, lo_, hi_, med_params_row) -> np.ndarray:
    """Writes the nonlinear medium's IOR profile and grid resolution into
    its parameter row and returns its IOR voxel grid, flat in
    (x * ry + y) * rz + z order: bottom_ior to top_ior lerped over the
    cell centres' relative height, as the reference voxelises it."""
    res = (int(props.get('res_x', 4)), int(props.get('res_y', 4)),
           int(props.get('res_z', 4)))
    med_params_row[M_NL_TOP_IOR] = float(props.get('top_ior', 0.7))
    med_params_row[M_NL_BOT_IOR] = float(props.get('bottom_ior', 1.0))
    med_params_row[M_NL_RES:M_NL_RES + 3] = res
    med_params_row[M_NL_FROM_BOTTOM] = \
        1.0 if props.get('from_bottom', True) else 0.0
    rx, ry, rz = res
    cell = (hi_ - lo_) / np.asarray(res, np.float64)
    ys = lo_[1] + (np.arange(ry) + 0.5) * cell[1]
    t = (ys - lo_[1]) / max(hi_[1] - lo_[1], 1e-30)
    ior_y = (1 - t) * med_params_row[M_NL_BOT_IOR] + \
        t * med_params_row[M_NL_TOP_IOR]
    grid = np.broadcast_to(ior_y[None, :, None], (rx, ry, rz))
    return np.ascontiguousarray(grid, np.float32).reshape(-1)


def _pack_media(media_rows: List[dict], med_bbox: dict):
    """(type, phase_type, params, density grid, nonlinear IOR grid,
    nonlinear medium index) of the scene's media, as the reference's
    builder packs them (one density grid and one IOR grid a scene)."""
    M_rows = max(len(media_rows), 1)
    med_type = np.zeros(M_rows, np.int32)
    med_phase = np.zeros(M_rows, np.int32)
    med_params = np.zeros((M_rows, MEDIUM_NPARAM), np.float32)
    grid_sigma = np.zeros((1, 1, 1), np.float32)
    nl_ior = np.ones((1,), np.float32)
    nl_medium = -1
    for mi, props in enumerate(media_rows):
        mt = props['type']
        if mt not in SLICE_MEDIA:
            raise not_in_slice(f"medium type '{mt}'", "item 8 (volumetrics)")
        med_type[mi] = MEDIUM_TYPES[mt]
        ph = props.get('phase', {'type': 'isotropic'})
        ph_type = ph.get('type', 'isotropic')
        if ph_type not in SLICE_PHASES:
            raise not_in_slice(f"phase function '{ph_type}'",
                               "item 8 (volumetrics)")
        med_phase[mi] = PHASE_TYPES[ph_type]
        # HG's default asymmetry is g = 0.8, as in the reference
        med_params[mi, M_PHASE_G] = float(ph.get('g', 0.8))             if ph_type == 'hg' else float(ph.get('g', 0.0))
        scale_v = float(props.get('scale', 1.0))
        med_params[mi, M_SCALE] = scale_v
        lo_, hi_ = med_bbox.get(mi, (np.zeros(3), np.ones(3)))
        med_params[mi, M_BBOX_MIN:M_BBOX_MIN + 3] = lo_
        med_params[mi, M_BBOX_MAX:M_BBOX_MAX + 3] = hi_
        if mt in ('homogeneous', 'nonlinear'):
            if 'sigma_s' in props or 'sigma_a' in props:
                ss = _rgb_of(props, 'sigma_s', 0.0)
                sa = _rgb_of(props, 'sigma_a', 0.0)
                st = ss + sa
                al = np.where(st > 0, ss / np.maximum(st, 1e-30), 0.0)
            else:
                st = _rgb_of(props, 'sigma_t', 1.0)
                al = _rgb_of(props, 'albedo', 0.75)
            if st is None or al is None:
                raise not_in_slice("textured homogeneous medium",
                                   "item 8 (volumetrics)")
            med_params[mi, M_SIGMA_T:M_SIGMA_T + 3] = st
            med_params[mi, M_ALBEDO:M_ALBEDO + 3] = al
            med_params[mi, M_MAJORANT:M_MAJORANT + 3] = st * scale_v
            if mt == 'nonlinear':
                nl_ior = _nl_ior_grid(props, lo_, hi_, med_params[mi])
                nl_medium = mi
            continue
        # heterogeneous
        stv = props.get('sigma_t')
        if isinstance(stv, dict) and stv.get('type') == 'gridvolume':
            vg = stv.get('_grid') or load_vol(stv['filename'])
            grid_sigma = np.asarray(vg.data, np.float32)[..., 0]
            # the grid's bbox maps lookups
            med_params[mi, M_BBOX_MIN:M_BBOX_MIN + 3] = vg.bbox_min
            med_params[mi, M_BBOX_MAX:M_BBOX_MAX + 3] = vg.bbox_max
            med_params[mi, M_SIGMA_T:M_SIGMA_T + 3] = 1.0
            med_params[mi, M_MAJORANT:M_MAJORANT + 3] = \
                vg.max_value * scale_v
        else:
            st = _rgb_of(props, 'sigma_t', 1.0)
            if st is None:
                raise not_in_slice(f"sigma_t texture {stv!r}",
                                   "item 8 (volumetrics)")
            med_params[mi, M_SIGMA_T:M_SIGMA_T + 3] = st
            med_params[mi, M_MAJORANT:M_MAJORANT + 3] = st * scale_v
        al = _rgb_of(props, 'albedo', 0.75)
        if al is None:
            av = props['albedo']
            if av.get('type') != 'constvolume':
                raise not_in_slice("albedo grids", "item 8 (volumetrics)")
            cv = av.get('value', av.get('color', 0.75))
            al = np.full(3, float(cv), np.float32) \
                if isinstance(cv, (int, float)) else \
                np.asarray(cv, np.float32)
        med_params[mi, M_ALBEDO:M_ALBEDO + 3] = al
    return med_type, med_phase, med_params, grid_sigma, nl_ior, nl_medium


def _medium_bboxes(shapes: List[dict], shape_rows: list,
                   meshes: list) -> dict:
    """World bbox of each medium over the shapes that hold it inside."""
    med_bbox = {}
    for srow, sh, mesh in zip(shape_rows, shapes, meshes):
        if srow[2] < 0:
            continue
        if mesh is None:
            c = np.asarray(sh.get('center', (0, 0, 0)), np.float64)
            r = float(sh.get('radius', 1.0))
            lo_, hi_ = c - r, c + r
        else:
            M = np.asarray(sh.get('to_world', Transform.identity()).m,
                           np.float64)
            v = mesh.vertices @ M[:3, :3].T + M[:3, 3]
            lo_, hi_ = v.min(0), v.max(0)
        prev = med_bbox.get(srow[2])
        if prev is not None:
            lo_, hi_ = np.minimum(lo_, prev[0]), np.maximum(hi_, prev[1])
        med_bbox[srow[2]] = (lo_, hi_)
    return med_bbox


class SceneBuilder:
    def __init__(self, desc: dict):
        self.desc = desc
        self.bsdf_rows: List[Tuple[int, int, list]] = []
        self.media_cache: Dict[int, int] = {}
        self.media_rows: List[dict] = []

    def _bsdf_index(self, props: Optional[dict]) -> int:
        # One row per shape, shared dicts included: the reference's table
        # has the same rows (its id-keyed cache is written under another
        # key and never hits), so both packages index alike.
        self.bsdf_rows.append(bsdf_mod.pack_params(props or
                                                   {'type': 'diffuse'}))
        return len(self.bsdf_rows) - 1

    def _medium_index(self, props: Optional[dict]) -> int:
        if props is None:
            return -1
        key = id(props)
        if key not in self.media_cache:
            self.media_cache[key] = len(self.media_rows)
            self.media_rows.append(props)
        return self.media_cache[key]

    def build(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """Returns (arrays, meta) in the form ``scene_from_numpy`` takes."""
        desc = self.desc
        # the reference's build_scene also turns float64 on from MNT_DOUBLE
        if desc.get('spectral') or desc.get('double') \
                or os.environ.get('MNT_DOUBLE', '') == '1':
            raise not_in_slice("spectral and double variants",
                               "item 10 (variants)")
        # --- film / sensor -------------------------------------------------
        sensor_desc = desc.get('sensor', {'type': 'perspective'})
        film_desc = sensor_desc.get('film', {})
        rfilter = film_desc.get('rfilter', {'type': 'gaussian'})
        if isinstance(rfilter, dict):
            rfilter = rfilter.get('type', 'gaussian')
        film = dict(width=int(film_desc.get('width', 256)),
                    height=int(film_desc.get('height', 256)),
                    rfilter=rfilter)
        sensor_type, sensor = build_sensor(sensor_desc, film['width'],
                                           film['height'])
        sampler_desc = sensor_desc.get('sampler', {'type': 'independent'})
        spp = int(sampler_desc.get('sample_count', 16))

        # --- shapes --------------------------------------------------------
        tri_v, tri_n, tri_uv, tri_shape = [], [], [], []
        sph_c, sph_r, sph_shape = [], [], []
        shape_rows = []     # (bsdf, emitter, interior, exterior medium)
        area_emitters = []  # (props, shape_idx)
        shape_tri_ranges = []
        shapes = desc.get('shapes', [])
        meshes = []
        for sh in shapes:
            if sh.get('type') in ('instance', 'shapegroup'):
                raise not_in_slice("shape instancing",
                                   "item 4 (scene front-end)")
            to_world = sh.get('to_world', Transform.identity())
            shape_idx = len(shape_rows)
            mesh = _load_shape_mesh(sh)
            meshes.append(mesh)
            bsdf_props = sh.get('bsdf')
            if bsdf_props is None and (sh.get('interior') is not None
                                       or sh.get('exterior') is not None):
                # a medium-only shape is a null boundary
                bsdf_props = _NULL_BSDF
            bsdf_idx = self._bsdf_index(bsdf_props)
            int_med = self._medium_index(sh.get('interior'))
            ext_med = self._medium_index(sh.get('exterior'))
            emitter_idx = -1
            if sh.get('emitter') is not None:
                emitter_idx = len(area_emitters)
                area_emitters.append((sh['emitter'], shape_idx))

            tri_start = sum(len(t) for t in tri_shape)
            if mesh is None:  # analytic sphere
                M = np.asarray(to_world.m)
                center = (M @ np.array([*sh.get('center', (0, 0, 0)),
                                        1.0]))[:3]
                scale_f = float(np.linalg.norm(M[:3, 0]))
                sph_c.append(center)
                sph_r.append(float(sh.get('radius', 1.0)) * scale_f)
                sph_shape.append(shape_idx)
                shape_tri_ranges.append((tri_start, 0))
            else:
                M = np.asarray(to_world.m, np.float64)
                Minv = np.asarray(to_world.inv, np.float64)
                v = mesh.vertices @ M[:3, :3].T + M[:3, 3]
                faces = mesh.faces
                if np.linalg.det(M[:3, :3]) < 0:
                    faces = faces[:, [0, 2, 1]]
                if mesh.normals is not None:
                    n = mesh.normals @ Minv[:3, :3]
                    ln = np.linalg.norm(n, axis=1, keepdims=True)
                    ln[ln == 0] = 1
                    n = n / ln
                else:
                    n = compute_vertex_normals(
                        MeshData(v.astype(np.float32), faces, None, None))
                uv = mesh.uvs if mesh.uvs is not None else \
                    np.zeros((len(v), 2), np.float32)
                tri_v.append(v[faces].astype(np.float32))       # (F,3,3)
                tri_n.append(n[faces].astype(np.float32))
                tri_uv.append(uv[faces].astype(np.float32))
                tri_shape.append(np.full(len(faces), shape_idx, np.int32))
                shape_tri_ranges.append((tri_start, len(faces)))
            shape_rows.append([bsdf_idx, emitter_idx, int_med, ext_med])

        if tri_v:
            V = np.concatenate(tri_v)      # (T, 3, 3)
            Nrm = np.concatenate(tri_n)
            UV = np.concatenate(tri_uv)
            TS = np.concatenate(tri_shape)
        else:
            V = np.zeros((0, 3, 3), np.float32)
            Nrm = np.zeros((0, 3, 3), np.float32)
            UV = np.zeros((0, 3, 2), np.float32)
            TS = np.zeros((0,), np.int32)
        T = len(V)

        # --- the BVH from BVH_MIN_TRIS triangles: reorder the triangles by
        # it; the emitters' triangle ids are remapped below
        bvh_np, tri_perm_inv = None, None
        if T >= BVH_MIN_TRIS:
            bvh_np = bvh_mod.build(V[:, 0], V[:, 1] - V[:, 0],
                                   V[:, 2] - V[:, 0])
            perm = bvh_np.order
            tri_perm_inv = np.empty(T, np.int64)
            tri_perm_inv[perm] = np.arange(T)
            V, Nrm, UV, TS = V[perm], Nrm[perm], UV[perm], TS[perm]

        # --- emitters: area emitters first (their index is list position) --
        emitter_rows = []       # (type, params, shape_idx)
        em_tri_idx, em_tri_cdf, em_area = [], [], []
        tri_offsets, tri_counts = [], []
        for props, shape_idx in area_emitters:
            code, params = emitter_mod.pack_params(props)
            start, count = shape_tri_ranges[shape_idx]
            idxs = np.arange(start, start + count, dtype=np.int32)
            if tri_perm_inv is not None:
                idxs = tri_perm_inv[idxs].astype(np.int32)
            e1 = V[idxs, 1] - V[idxs, 0]
            e2 = V[idxs, 2] - V[idxs, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
            total = float(areas.sum()) if count else 0.0
            cdf = np.cumsum(areas) / max(total, 1e-30)
            tri_offsets.append(sum(len(x) for x in em_tri_idx))
            tri_counts.append(count)
            em_tri_idx.append(idxs)
            em_tri_cdf.append(cdf.astype(np.float32))
            em_area.append(total)
            emitter_rows.append((code, params, shape_idx))
        for props in desc.get('emitters', []):
            code, params = emitter_mod.pack_params(props)
            tw = props.get('to_world')
            if tw is not None and code == EMITTER_TYPES['point']:
                M = np.asarray(tw.m)
                params[0:3] = list((M @ np.array([*params[0:3], 1.0]))[:3])
            emitter_rows.append((code, params, -1))
            tri_offsets.append(sum(len(x) for x in em_tri_idx))
            tri_counts.append(0)
            em_area.append(0.0)
        E = len(emitter_rows)

        # --- media ---------------------------------------------------------
        med_type, med_phase, med_params, grid_sigma, nl_ior, nl_medium = \
            _pack_media(
            self.media_rows, _medium_bboxes(shapes, shape_rows, meshes))
        n_media = len(self.media_rows)

        # --- assemble ------------------------------------------------------
        if T:
            v0 = V[:, 0]
            e1 = V[:, 1] - V[:, 0]
            e2 = V[:, 2] - V[:, 0]
        else:
            v0 = e1 = e2 = np.zeros((0, 3), np.float32)
        all_pts = [V.reshape(-1, 3)] if T else []
        for c, r in zip(sph_c, sph_r):
            all_pts.append(np.asarray(c)[None, :] - r)
            all_pts.append(np.asarray(c)[None, :] + r)
        if all_pts:
            pts = np.concatenate(all_pts)
            lo, hi = pts.min(0), pts.max(0)
        else:
            lo, hi = np.zeros(3), np.ones(3)
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center)) + 1e-4

        sr = np.asarray(shape_rows, np.int32).reshape(-1, 4)
        if self.bsdf_rows:
            btype = np.asarray([r[0] for r in self.bsdf_rows], np.int32)
            bflags = np.asarray([r[1] for r in self.bsdf_rows], np.int32)
            bparams = np.asarray([r[2] for r in self.bsdf_rows], np.float32)
        else:
            btype = np.zeros((1,), np.int32)
            bflags = np.zeros((1,), np.int32)
            bparams = np.zeros((1, BSDF_NPARAM), np.float32)

        f32 = np.float32
        arrays = {
            'geo.v0': v0, 'geo.e1': e1, 'geo.e2': e2,
            'geo.n0': Nrm[:, 0], 'geo.n1': Nrm[:, 1], 'geo.n2': Nrm[:, 2],
            'geo.uv0': UV[:, 0], 'geo.uv1': UV[:, 1], 'geo.uv2': UV[:, 2],
            'geo.shape_idx': TS,
            'geo.sph_center': np.asarray(sph_c, f32).reshape(-1, 3),
            'geo.sph_radius': np.asarray(sph_r, f32),
            'geo.sph_shape_idx': np.asarray(sph_shape, np.int32),
            'shapes.bsdf_idx': sr[:, 0], 'shapes.emitter_idx': sr[:, 1],
            'shapes.int_medium': sr[:, 2], 'shapes.ext_medium': sr[:, 3],
            'bsdfs.type': btype, 'bsdfs.flags': bflags,
            'bsdfs.params': bparams,
            'emitters.type': np.asarray([r[0] for r in emitter_rows],
                                        np.int32),
            'emitters.params': np.asarray([r[1] for r in emitter_rows],
                                          f32).reshape(E, EMITTER_NPARAM),
            'emitters.shape_idx': np.asarray([r[2] for r in emitter_rows],
                                             np.int32),
            'emitters.tri_offset': np.asarray(tri_offsets, np.int32),
            'emitters.tri_count': np.asarray(tri_counts, np.int32),
            'emitters.em_tri_idx': (np.concatenate(em_tri_idx) if em_tri_idx
                                    else np.zeros(0, np.int32)),
            'emitters.em_tri_cdf': (np.concatenate(em_tri_cdf) if em_tri_cdf
                                    else np.zeros(0, f32)),
            'emitters.em_area': np.asarray(em_area, f32),
            'bbox_lo': np.asarray(lo, f32), 'bbox_hi': np.asarray(hi, f32),
            'bsphere_c': np.asarray(center, f32),
            'bsphere_r': np.asarray(radius, f32),
        }
        arrays.update({f'sensor.{k}': v for k, v in sensor.items()})
        if bvh_np is not None:
            arrays.update({f'bvh.{k}': v
                           for k, v in bvh_np._asdict().items()})
        dense = grid_sigma.size > 1
        arrays.update({
            'media.type': med_type, 'media.phase_type': med_phase,
            'media.params': med_params, 'media.grid_sigma_t': grid_sigma,
            'media.grid_sup': (_supervoxel_max(grid_sigma) if dense
                               else np.ones((1, 1, 1), f32)),
            'media.grid_sup_min': (_supervoxel_min(grid_sigma) if dense
                                   else np.zeros((1, 1, 1), f32)),
            'media.nl_ior': nl_ior,
            'media.nl_medium': np.asarray(nl_medium, np.int32)})
        if dense and grid_sigma.size <= _PACK_MAX_VOXELS:
            arrays['media.grid_sigma_p8'] = _corner_pack(grid_sigma)

        integ = desc.get('integrator', {'type': 'path'})
        meta = dict(
            n_tris=T, n_spheres=len(sph_c), n_shapes=len(shape_rows),
            n_bsdfs=len(btype), n_emitters=E, n_media=n_media,
            bsdf_types=tuple(sorted(set(int(x) for x in btype))),
            emitter_types=tuple(sorted(set(int(r[0])
                                           for r in emitter_rows))),
            medium_types=tuple(int(x) for x in med_type[:n_media]),
            phase_types=tuple(sorted(set(int(x)
                                         for x in med_phase[:n_media]))),
            has_media=n_media > 0, has_bvh=bvh_np is not None,
            sensor_type=sensor_type, film=film,
            sampler=sampler_desc.get('type', 'independent'), spp=spp,
            integrator=integ.get('type', 'path'),
            integrator_props=tuple(sorted(
                (k, v) for k, v in integ.items() if k != 'type')))
        return arrays, meta


def resolve_device(device=None) -> torch.device:
    """The render device: CUDA unless the caller names another. Without a
    card and without an explicit device this raises; it never drops to the
    CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to build "
                "and render on the CPU")
        return torch.device('cuda')
    return torch.device(device)


# Scene flags of the reference's SceneMeta that name features outside this
# slice, with the ROADMAP item that ports each.
_OUT_OF_SLICE_FLAGS = {
    'has_textures': "item 7 (textures)",
    'has_param_textures': "item 7 (textures)",
    'spectral': "item 10 (variants)",
    'has_conductor_spd': "item 10 (variants)",
    'measured_meta': "item 10 (variants)",
}


def scene_from_numpy(arrays: dict, meta: dict, device=None
                     ) -> Tuple[SceneData, SceneMeta]:
    """Build the port's ``SceneData``/``SceneMeta`` from numpy arrays.

    ``arrays`` maps dotted field paths of the reference's ``SceneData``
    ("geo.v0", "emitters.em_tri_cdf", "sensor.to_world.m", ...) to numpy
    arrays; keys this slice does not read are ignored. ``meta`` holds the
    fields of the reference's ``SceneMeta`` (``film`` as a dict). Nothing
    here imports JAX: the caller flattens a reference scene into numpy
    first."""
    device = resolve_device(device)
    for name, item in _OUT_OF_SLICE_FLAGS.items():
        if meta.get(name):
            raise not_in_slice(f"scene feature '{name}'", item)
    known = {f.name for f in fields(SceneMeta)}
    kw = {k: v for k, v in meta.items() if k in known}
    kw['film'] = FilmMeta(**{k: v for k, v in dict(meta['film']).items()
                             if k in ('width', 'height', 'rfilter')})
    for k in ('bsdf_types', 'emitter_types', 'medium_types', 'phase_types'):
        kw[k] = tuple(int(x) for x in kw.get(k, ()))
    kw['integrator_props'] = tuple(
        tuple(p) for p in kw.get('integrator_props', ()))
    meta_t = SceneMeta(**kw)
    check_meta(meta_t)

    def get(key, dtype):
        a = np.asarray(arrays[key])
        return torch.as_tensor(np.array(a, dtype), device=device)

    def table(cls, prefix, dtypes):
        return cls(**{f: get(f'{prefix}.{f}', dtypes.get(f, np.float32))
                      for f in cls._fields})

    i32 = np.int32
    geo = table(Geometry, 'geo', {'shape_idx': i32, 'sph_shape_idx': i32})
    shapes = table(ShapeTable, 'shapes', {
        'bsdf_idx': i32, 'emitter_idx': i32, 'int_medium': i32,
        'ext_medium': i32})
    bsdfs = table(BSDFTable, 'bsdfs', {'type': i32, 'flags': i32})
    emitters = table(EmitterTable, 'emitters', {
        'type': i32, 'shape_idx': i32, 'tri_offset': i32, 'tri_count': i32,
        'em_tri_idx': i32})
    media = MediumTable(
        type=get('media.type', i32), phase_type=get('media.phase_type', i32),
        **{f: get(f'media.{f}', np.float32)
           for f in ('params', 'grid_sigma_t', 'grid_sup', 'grid_sup_min',
                     'nl_ior')},
        nl_medium=get('media.nl_medium', i32),
        grid_sigma_p8=(get('media.grid_sigma_p8', np.float32)
                       if arrays.get('media.grid_sigma_p8') is not None
                       else None))
    if (np.asarray(arrays['bsdfs.flags']) & F_MASK).any():
        raise not_in_slice("bsdf type 'mask'", "item 7 (materials)")
    # the occluder subset, once per scene: triangles whose BSDF is not null
    tri_bsdf = np.asarray(arrays['shapes.bsdf_idx'])[
        np.asarray(arrays['geo.shape_idx'], np.int64)]
    occ = np.asarray(arrays['bsdfs.type'])[tri_bsdf] != BSDF_TYPES['null']
    if occ.all():
        occluders = Occluders(geo.v0, geo.e1, geo.e2)
    else:
        sel = torch.as_tensor(np.flatnonzero(occ), device=device)
        occluders = Occluders(*(x[sel].contiguous()
                                for x in (geo.v0, geo.e1, geo.e2)))
    to_world = Transform(get('sensor.to_world.m', np.float32),
                         get('sensor.to_world.inv', np.float32))
    sensor = SensorData(to_world=to_world, **{
        f: get(f'sensor.{f}', np.float32)
        for f in SensorData._fields if f != 'to_world'})
    bvh = None
    if arrays.get('bvh.node_lo') is not None:
        bvh = bvh_mod.BVHArrays(**{
            f: get(f'bvh.{f}', dt) for f, dt in (
                ('node_lo', np.float32), ('node_hi', np.float32),
                ('node_a', i32), ('node_b', i32), ('node_leaf', bool),
                ('order', i32))})
    scene = SceneData(geo=geo, shapes=shapes, bsdfs=bsdfs, emitters=emitters,
                      media=media, occluders=occluders, sensor=sensor,
                      bvh=bvh,
                      **{k: get(k, np.float32) for k in
                         ('bbox_lo', 'bbox_hi', 'bsphere_c', 'bsphere_r')})
    return scene, meta_t


def build_scene(desc: dict, device=None) -> Tuple[SceneData, SceneMeta]:
    """Description dict -> (SceneData on ``device``, SceneMeta). The device
    defaults to CUDA; with no card, pass ``device='cpu'``."""
    device = resolve_device(device)
    arrays, meta = SceneBuilder(desc).build()
    return scene_from_numpy(arrays, meta, device)

"""Scene builder: description dicts -> SoA tensors.

Port of ``mitsuba_nlvrl_tpu/scene/builder.py`` for the types the port
renders (``types.SLICE_*``). A scene description (nested dicts, as
``testing/scenes.py`` makes them) is flattened on the host into numpy
arrays keyed like the reference's ``SceneData`` fields ("geo.v0",
"bsdfs.params", "sensor.to_world.m", "emitters.env_warp.levels.0", ...),
and ``scene_from_numpy`` turns those into tensors on the render device.
The reference's own build goes through the same function, which is how
the tests render the very same arrays in both packages.

All geometry is pre-transformed to world space; rectangles and cubes
become exact triangle pairs, disks and cylinders tessellate, OBJ, PLY,
Mitsuba .serialized and Blender meshes load through ``mesh_io``; spheres
stay analytic unless emissive (area emitters sample triangles, so an
emissive sphere tessellates). ``shapegroup``/``instance`` are flattened:
each instance adds its group's shapes under the composed transform. From
``BVH_MIN_TRIS`` triangles the builder makes the reference's BVH
(``ops/bvh.build``), reorders the triangle tables by it and remaps the
emitters' triangle ids, as the reference does; below it the triangles
keep their input order and the dense kernel intersects them. The
reference's TPU cluster arrays are not built.

Textures (BSDF parameters, the wrapper BSDFs' weights and normals, the
projector's slide) become rows of a texture table with their bitmaps and
volumes stacked; meshes with vertex colours carry per-corner colours for
``mesh_attribute``. An ``envmap`` gets its texels and the Hierarchical2D
warp of its luminance; a missing envmap file is replaced by the
reference's procedural sky.

A ``measured`` or ``measured_polarized`` BSDF reads its tensor file
(``filename``, or parsed ``_fields``) into the scene's ``measured`` and
``measured_pol`` tables. ``desc['double']`` or ``MNT_DOUBLE=1`` makes
every float table float64 (the double variant), and so does a reference
scene whose arrays are float64.

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

from ..core.cie_data import CIE_SAMPLES
from ..core.transform import Transform
from .types import (SceneData, SceneMeta, FilmMeta, Geometry, ShapeTable,
                    BSDFTable, EmitterTable, MediumTable, Occluders,
                    SensorData, BSDF_NPARAM, BSDF_TYPES, EMITTER_NPARAM,
                    EMITTER_TYPES, MEDIUM_NPARAM, MEDIUM_TYPES, PHASE_TYPES,
                    M_SIGMA_T, M_ALBEDO, M_SCALE, M_PHASE_G, M_BBOX_MIN,
                    M_BBOX_MAX, M_MAJORANT, M_NL_TOP_IOR, M_NL_BOT_IOR,
                    M_NL_RES, M_NL_FROM_BOTTOM, SLICE_MEDIA, SLICE_PHASES,
                    BVH_MIN_TRIS, TEXTURE_TYPES, TEX_NPARAM, F_SMOOTH,
                    SLICE_SHAPES, TextureTable, check_meta)
from .mesh_io import (MeshData, compute_vertex_normals, load_blender,
                      load_obj, load_ply, load_serialized)
from .ior_data import spd_curves
from .vol_io import load_vol
from ..ops import bvh as bvh_mod
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from .. import texture as tex_mod
from ..core import distr2d
from ..bsdf.measured import MeasuredMeta
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
        raise NotImplementedError(f"shape type {t}")
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


def _procedural_sky(H: int = 64, W: int = 128) -> np.ndarray:
    """The reference's stand-in for a missing envmap file: a blue to
    horizon gradient, a bright warm sun disk 30 degrees up and a dim
    brown ground."""
    theta = (np.arange(H) + 0.5) / H * np.pi          # 0 = up
    phi = (np.arange(W) + 0.5) / W * 2.0 * np.pi
    t, p = np.meshgrid(theta, phi, indexing='ij')
    sky_t = np.clip(t / (0.5 * np.pi), 0.0, 1.0)      # 0 zenith -> 1 horizon
    zen = np.array([0.35, 0.55, 1.15])
    hor = np.array([1.05, 0.95, 0.85])
    img = zen[None, None] * (1 - sky_t[..., None]) \
        + hor[None, None] * sky_t[..., None]
    img[t > 0.5 * np.pi] = np.array([0.22, 0.17, 0.12])
    # a sun disk of about 4 degrees radius at 30 degrees elevation
    sun_dir = np.array([np.cos(np.radians(30)) * 1.0, 0.0,
                        np.sin(np.radians(30))])
    d = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                  np.cos(t)], axis=-1)
    cosang = d @ np.array([sun_dir[0], sun_dir[1], sun_dir[2]])
    img[cosang > np.cos(np.radians(4.0))] = np.array([60.0, 52.0, 40.0])
    return img.astype(np.float32)


def _env_tables(desc: dict):
    """(texels, luminance nodes, to_world, scale) of the scene's first
    envmap, or None. The luminance is sampled at the node grid with sin
    theta at theta = y / (H - 1) pi, zero at the poles."""
    env_descs = [e for e in desc.get('emitters', [])
                 if e.get('type') == 'envmap']
    if not env_descs:
        return None
    eprops = env_descs[0]
    from ..utils.io import read_exr
    try:
        img, names = read_exr(eprops['filename'])
        if set('RGB') <= set(names):
            img = img[:, :, [names.index(c) for c in 'RGB']]
        img = img[:, :, :3]
    except FileNotFoundError:
        print(f"warning: envmap '{eprops.get('filename')}' not found; "
              f"substituting a procedural gradient+sun sky")
        img = _procedural_sky()
    env_map = np.ascontiguousarray(img, np.float32)
    He = env_map.shape[0]
    lum = (env_map * np.array([0.2126, 0.7152, 0.0722])).sum(-1)
    sin_t = np.sin(np.arange(He) / max(He - 1, 1) * np.pi)
    env_lum = (lum * sin_t[:, None] + 1e-12).astype(np.float32)
    return (env_map, env_lum,
            eprops.get('to_world', Transform.identity()),
            float(eprops.get('scale', 1.0)))


def _expand_instances(shapes: List[dict]) -> List[dict]:
    """Shapegroups are not drawn; each instance adds its group's shapes
    under the instance's transform composed with their own."""
    out = []
    for sh in shapes:
        t = sh.get('type')
        if t == 'shapegroup':
            continue
        if t == 'instance':
            subs = sh.get('shapegroup', {}).get('shape', [])
            if isinstance(subs, dict):
                subs = [subs]
            T_inst = sh.get('to_world', Transform.identity())
            for sub in subs:
                sub2 = dict(sub)
                sub2['to_world'] = T_inst @ sub.get('to_world',
                                                    Transform.identity())
                out.append(sub2)
            continue
        out.append(sh)
    return out


def _texture_arrays(tex_rows, bitmaps, volumes) -> dict:
    """The texture table's arrays: bitmaps and volumes stacked, each
    padded to the largest; a table of one empty row without textures."""
    f32 = np.float32
    if not tex_rows:
        return {'textures.type': np.zeros((1,), np.int32),
                'textures.params': np.zeros((1, TEX_NPARAM), f32),
                'textures.data': np.zeros((1, 1, 1, 3), f32),
                'textures.size': np.zeros((1, 2), np.int32)}
    out = {'textures.type': np.asarray([r[0] for r in tex_rows], np.int32),
           'textures.params': np.asarray([r[1] for r in tex_rows], f32)}
    sizes = np.zeros((len(tex_rows), 2), np.int32)
    if bitmaps:
        Hm = max(b.shape[0] for b in bitmaps)
        Wm = max(b.shape[1] for b in bitmaps)
        data = np.zeros((len(bitmaps), Hm, Wm, 3), f32)
        for bi, b in enumerate(bitmaps):
            data[bi, :b.shape[0], :b.shape[1]] = b
        for ti, (tc, tp) in enumerate(tex_rows):
            if tc == TEXTURE_TYPES['bitmap']:
                sizes[ti] = bitmaps[int(tp[0])].shape[:2]
    else:
        data = np.zeros((1, 1, 1, 3), f32)
    out['textures.data'] = data
    out['textures.size'] = sizes
    if volumes:
        shape = [max(v.shape[k] for v in volumes) for k in range(3)]
        vol = np.zeros((len(volumes), *shape, 3), f32)
        for vi, vv in enumerate(volumes):
            vol[vi, :vv.shape[0], :vv.shape[1], :vv.shape[2]] = vv
        vol_size = np.ones((len(tex_rows), 3), np.int32)
        for ti, (tc, tp) in enumerate(tex_rows):
            if tc == TEXTURE_TYPES['grid3d']:
                vol_size[ti] = volumes[int(tp[0])].shape[:3]
        out['textures.vol'] = vol
        out['textures.vol_size'] = vol_size
    return out

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
    """(type, phase_type, params, density grid, albedo grid, nonlinear
    IOR grid, nonlinear medium index) of the scene's media, as the
    reference's builder packs them (one density grid, one albedo grid and
    one IOR grid a scene)."""
    M_rows = max(len(media_rows), 1)
    med_type = np.zeros(M_rows, np.int32)
    med_phase = np.zeros(M_rows, np.int32)
    med_params = np.zeros((M_rows, MEDIUM_NPARAM), np.float32)
    grid_sigma = np.zeros((1, 1, 1), np.float32)
    grid_albedo = np.zeros((1, 1, 1, 3), np.float32)
    nl_ior = np.ones((1,), np.float32)
    nl_medium = -1
    for mi, props in enumerate(media_rows):
        mt = props['type']
        if mt not in SLICE_MEDIA:
            raise ValueError(f"unknown medium type '{mt}'")
        med_type[mi] = MEDIUM_TYPES[mt]
        ph = props.get('phase', {'type': 'isotropic'})
        ph_type = ph.get('type', 'isotropic')
        if ph_type not in SLICE_PHASES:
            raise ValueError(f"unknown phase function '{ph_type}'")
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
                st = al = None
                if ss is not None and sa is not None:
                    st = ss + sa
                    al = np.where(st > 0, ss / np.maximum(st, 1e-30), 0.0)
            else:
                st = _rgb_of(props, 'sigma_t', 1.0)
                al = _rgb_of(props, 'albedo', 0.75)
            if st is None or al is None:
                raise ValueError(
                    f"medium {mi}: a {mt} medium takes constant sigma_t, "
                    f"sigma_s, sigma_a and albedo; a texture there is "
                    f"refused, as the reference builder refuses it")
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
                raise ValueError(
                    f"medium {mi}: a heterogeneous medium's textured "
                    f"sigma_t must be a gridvolume, not {stv.get('type')!r}; "
                    f"the reference builder refuses it too")
            med_params[mi, M_SIGMA_T:M_SIGMA_T + 3] = st
            med_params[mi, M_MAJORANT:M_MAJORANT + 3] = st * scale_v
        al = _rgb_of(props, 'albedo', 0.75)
        if al is None:
            av = props['albedo']
            if av.get('type') == 'gridvolume':
                # carried but not read: the reference's media and
                # integrators never look grid_albedo up, so the row's
                # albedo is one (ROADMAP C, reference facts)
                vg2 = av.get('_grid') or load_vol(av['filename'])
                d = np.asarray(vg2.data, np.float32)
                grid_albedo = d if d.shape[-1] == 3 else \
                    np.repeat(d, 3, axis=-1)
                al = np.ones(3, np.float32)
            elif av.get('type') == 'constvolume':
                cv = av.get('value', av.get('color', 0.75))
                al = np.full(3, float(cv), np.float32) \
                    if isinstance(cv, (int, float)) else \
                    np.asarray(cv, np.float32)
            else:
                raise ValueError(
                    f"medium {mi}: albedo texture {av.get('type')!r} is "
                    f"neither a gridvolume nor a constvolume; the "
                    f"reference builder refuses it too")
        med_params[mi, M_ALBEDO:M_ALBEDO + 3] = al
    return (med_type, med_phase, med_params, grid_sigma, grid_albedo,
            nl_ior, nl_medium)


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
        # the wrapper rows (blendbsdf, normalmap, bumpmap) by id(props)
        self.bsdf_cache: Dict[int, int] = {}
        self.media_cache: Dict[int, int] = {}
        self.media_rows: List[dict] = []
        self.tex_rows: List[Tuple[int, list]] = []
        self.tex_bitmaps: List[np.ndarray] = []
        self.tex_volumes: List[np.ndarray] = []
        self.tex_cache: Dict[int, int] = {}
        # the named attribute of the scene's mesh_attribute textures whose
        # colours the corner buffer holds (one name a scene)
        self.mesh_attr_name: Optional[str] = None
        # measured materials: (arrays keyed by the MeasuredData field path,
        # MeasuredMeta) and the measured polarized grids' arrays
        self.measured: List[Tuple[dict, tuple]] = []
        self.measured_pol: List[dict] = []

    def _texture_index(self, props: dict) -> int:
        key = id(props)
        if key in self.tex_cache:
            return self.tex_cache[key]
        if props.get('type') == 'mesh_attribute':
            name = props.get('name', 'vertex_color')
            prev = self.mesh_attr_name
            if prev is not None and prev != name:
                print(f"warning: multiple mesh_attribute names "
                      f"({prev!r}, {name!r}); only {prev!r} is buffered")
            else:
                self.mesh_attr_name = name
        self.tex_rows.append(tex_mod.pack(props, self.tex_bitmaps,
                                          self.tex_volumes))
        self.tex_cache[key] = len(self.tex_rows) - 1
        return self.tex_cache[key]

    def _wrapper_row(self, key: int, code: int, flags: int, p: list) -> int:
        self.bsdf_rows.append((code, flags, p))
        self.bsdf_cache[key] = len(self.bsdf_rows) - 1
        return self.bsdf_cache[key]

    def _measured_row(self, key: int, kind: str, props: dict) -> int:
        """A measured material's row: its tables go to the scene's
        ``measured`` (or ``measured_pol``) tuple, read from ``filename``
        or from the parsed fields in ``_fields``, and the row holds the
        slot in param 0 (and the polarized mixture's alpha and a fixed
        wavelength in params 1-2)."""
        from ..bsdf import measured as meas_mod, measured_pol as mp_mod
        tf = props.get('_fields')
        if tf is None:
            tf = meas_mod.read_tensor_file(props['filename'])
        p = [0.0] * BSDF_NPARAM
        if kind == 'measured':
            data, mm = meas_mod.load_fields(tf, device='cpu')
            p[0] = float(len(self.measured))
            self.measured.append((_flat_arrays(data), mm))
        else:
            p[0] = float(len(self.measured_pol))
            self.measured_pol.append(_flat_arrays(
                mp_mod.load_fields(tf, device='cpu')))
            p[1] = float(props.get('alpha_sample', 0.1))
            p[2] = float(props.get('wavelength', -1.0))
        return self._wrapper_row(key, BSDF_TYPES[kind], F_SMOOTH, p)

    def _bsdf_index(self, props: Optional[dict]) -> int:
        # A plain BSDF gets a row of its own each time, shared dicts
        # included: the reference's id-keyed cache is written under
        # another key for them and never hits, so both packages index
        # alike. Its wrapper rows are cached by the wrapper dict's id.
        if props is None:
            props = {'type': 'diffuse'}
        key = id(props)
        if key in self.bsdf_cache:
            return self.bsdf_cache[key]
        kind = props.get('type')
        if kind in ('normalmap', 'bumpmap'):
            # the nested row, the perturbing texture and the bump scale
            nested = props.get('bsdf', {'type': 'diffuse'})
            if isinstance(nested, list):
                nested = nested[0]
            row_n = self._bsdf_index(nested)
            tex = props.get(kind) or props.get('texture')
            if tex is None:   # any other child dict with a texture type
                tex = next((v for v in props.values() if isinstance(v, dict)
                            and v.get('type') in TEXTURE_TYPES), None)
            p = [0.0] * BSDF_NPARAM
            p[0] = float(row_n)
            p[1] = float(self._texture_index(tex) if tex is not None
                         else -1)
            p[2] = float(props.get('scale', 1.0))
            return self._wrapper_row(key, BSDF_TYPES[kind],
                                     self.bsdf_rows[row_n][1], p)
        if kind in ('measured', 'measured_polarized'):
            return self._measured_row(key, kind, props)
        if kind == 'blendbsdf':
            subs = props.get('bsdf', [])
            if isinstance(subs, dict):
                subs = [subs, {'type': 'diffuse'}]
            row_a = self._bsdf_index(subs[0])
            row_b = self._bsdf_index(subs[1])
            w = props.get('weight', 0.5)
            p = [0.0] * BSDF_NPARAM
            p[0], p[1] = float(row_a), float(row_b)
            if isinstance(w, dict):
                # a textured weight: slot 19 = texture id + 1
                p[2] = 0.5
                p[19] = float(self._texture_index(w)) + 1.0
            else:
                p[2] = float(w)
            return self._wrapper_row(
                key, BSDF_TYPES['blendbsdf'],
                self.bsdf_rows[row_a][1] | self.bsdf_rows[row_b][1], p)
        # textured parameters: register the textures, pass their ids
        for name, marker in (('reflectance', '_texture_id'),
                             ('diffuse_reflectance', '_texture_id'),
                             ('alpha', '_alpha_tex'),
                             ('specular_reflectance', '_spec_tex'),
                             ('opacity', '_opacity_tex')):
            if isinstance(props.get(name), dict) and marker not in props:
                props = dict(props,
                             **{marker: self._texture_index(props[name])})
        self.bsdf_rows.append(bsdf_mod.pack_params(props))
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
        tri_c = []          # per-corner colours (mesh_attribute)
        any_colors = False
        shapes = _expand_instances(desc.get('shapes', []))
        meshes = []
        for sh in shapes:
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
                # the colours of the attribute the textures name so far: a
                # face attribute repeats over its corners
                attr_name = self.mesh_attr_name or 'vertex_color'
                fa = mesh.face_attrs or {}
                if attr_name.startswith('face_') and attr_name[5:] in fa:
                    fv = fa[attr_name[5:]].astype(np.float32)   # (F, 3)
                    tri_c.append(np.repeat(fv[:, None, :], 3, axis=1))
                    any_colors = True
                elif mesh.colors is not None:
                    tri_c.append(mesh.colors[faces].astype(np.float32))
                    any_colors = True
                else:
                    tri_c.append(np.zeros((len(faces), 3, 3), np.float32))
                tri_shape.append(np.full(len(faces), shape_idx, np.int32))
                shape_tri_ranges.append((tri_start, len(faces)))
            shape_rows.append([bsdf_idx, emitter_idx, int_med, ext_med])

        if tri_v:
            V = np.concatenate(tri_v)      # (T, 3, 3)
            Nrm = np.concatenate(tri_n)
            UV = np.concatenate(tri_uv)
            TS = np.concatenate(tri_shape)
            C = np.concatenate(tri_c) if any_colors else None
        else:
            V = np.zeros((0, 3, 3), np.float32)
            Nrm = np.zeros((0, 3, 3), np.float32)
            UV = np.zeros((0, 3, 2), np.float32)
            TS = np.zeros((0,), np.int32)
            C = None
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
            if C is not None:
                C = C[perm]

        # --- emitters: area emitters first (their index is list position) --
        emitter_rows = []       # (type, params, shape_idx)
        em_tri_idx, em_tri_cdf, em_area = [], [], []
        tri_offsets, tri_counts = [], []
        emitter_specs = []      # (kind, param, scale) per emitter
        spd_rows = []           # the tabulated SPDs SPEC_TABLE rows name

        def reg_spec(spec):
            kind, param, sscale, table = spec
            if table is not None:
                param = float(len(spd_rows))
                spd_rows.append(np.asarray(table, np.float32))
            emitter_specs.append((kind, param, sscale))

        for props, shape_idx in area_emitters:
            code, params, espec = emitter_mod.pack_params(props)
            reg_spec(espec)
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
            if props.get('type') == 'projector' \
                    and isinstance(props.get('irradiance'), dict):
                # the slide texture, and its bitmap's aspect
                tid = self._texture_index(props['irradiance'])
                tc, tp = self.tex_rows[tid]
                aspect = 1.0
                if tc == TEXTURE_TYPES['bitmap']:
                    b = self.tex_bitmaps[int(tp[0])]
                    aspect = b.shape[1] / b.shape[0]
                props = dict(props, _irradiance_tex=tid, _aspect=aspect)
            code, params, espec = emitter_mod.pack_params(props)
            reg_spec(espec)
            tw = props.get('to_world')
            if tw is not None and code == EMITTER_TYPES['point']:
                M = np.asarray(tw.m)
                params[0:3] = list((M @ np.array([*params[0:3], 1.0]))[:3])
            emitter_rows.append((code, params, -1))
            tri_offsets.append(sum(len(x) for x in em_tri_idx))
            tri_counts.append(0)
            em_area.append(0.0)
        E = len(emitter_rows)

        # --- the environment map (at most one) -------------------------
        env = _env_tables(desc)
        if env is None:
            env_map = np.zeros((1, 1, 3), np.float32)
            env_lum = np.ones((2, 2), np.float32)
            env_to_world, env_scale = Transform.identity(), 1.0
        else:
            env_map, env_lum, env_to_world, env_scale = env
        env_nodes, env_levels = distr2d.build_hierarchical_np(env_lum)

        # --- media ---------------------------------------------------------
        (med_type, med_phase, med_params, grid_sigma, grid_albedo, nl_ior,
         nl_medium) = _pack_media(
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

        # tabulated conductor eta/k curves of the spectral variant: live
        # when some conductor's slot 13 names one (curve id + 1)
        curves = spd_curves()
        has_cond_spd = bool(
            curves is not None
            and any(r[0] in (BSDF_TYPES['conductor'],
                             BSDF_TYPES['roughconductor'])
                    and r[2][13] > 0 for r in self.bsdf_rows))
        cond_spd = (curves if has_cond_spd
                    else np.zeros((1, 2, CIE_SAMPLES), np.float32))

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
            'emitters.spec_kind': np.asarray(
                [e[0] for e in emitter_specs], np.int32).reshape(E),
            'emitters.spec_param': np.asarray(
                [e[1] for e in emitter_specs], f32).reshape(E),
            'emitters.spec_scale': np.asarray(
                [e[2] for e in emitter_specs], f32).reshape(E),
            'emitters.spec_table': (np.stack(spd_rows) if spd_rows
                                    else np.zeros((1, 95), f32)),
            'conductor_spd': cond_spd,
            'bbox_lo': np.asarray(lo, f32), 'bbox_hi': np.asarray(hi, f32),
            'bsphere_c': np.asarray(center, f32),
            'bsphere_r': np.asarray(radius, f32),
        }
        if C is not None:
            arrays.update({'geo.c0': C[:, 0], 'geo.c1': C[:, 1],
                           'geo.c2': C[:, 2]})
        arrays.update({
            'emitters.env_map': env_map,
            'emitters.env_warp.nodes': env_nodes,
            'emitters.env_to_world.m': np.asarray(env_to_world.m, f32),
            'emitters.env_to_world.inv': np.asarray(env_to_world.inv, f32),
            'emitters.env_scale': np.asarray(env_scale, f32)})
        arrays.update({f'emitters.env_warp.levels.{k}': lv
                       for k, lv in enumerate(env_levels)})
        arrays.update(_texture_arrays(self.tex_rows, self.tex_bitmaps,
                                      self.tex_volumes))
        arrays.update({f'sensor.{k}': v for k, v in sensor.items()})
        if bvh_np is not None:
            arrays.update({f'bvh.{k}': v
                           for k, v in bvh_np._asdict().items()})
        dense = grid_sigma.size > 1
        arrays.update({
            'media.type': med_type, 'media.phase_type': med_phase,
            'media.params': med_params, 'media.grid_sigma_t': grid_sigma,
            'media.grid_albedo': grid_albedo,
            'media.grid_sup': (_supervoxel_max(grid_sigma) if dense
                               else np.ones((1, 1, 1), f32)),
            'media.grid_sup_min': (_supervoxel_min(grid_sigma) if dense
                                   else np.zeros((1, 1, 1), f32)),
            'media.nl_ior': nl_ior,
            'media.nl_medium': np.asarray(nl_medium, np.int32)})
        if dense and grid_sigma.size <= _PACK_MAX_VOXELS:
            arrays['media.grid_sigma_p8'] = _corner_pack(grid_sigma)
        for k, (flat, _) in enumerate(self.measured):
            arrays.update({f'measured.{k}.{f}': a for f, a in flat.items()})
        for k, flat in enumerate(self.measured_pol):
            arrays.update({f'measured_pol.{k}.{f}': a
                           for f, a in flat.items()})

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
            has_textures=len(self.tex_rows) > 0,
            has_3d_textures=any(r[0] == TEXTURE_TYPES['grid3d']
                                for r in self.tex_rows),
            has_attr_textures=C is not None and any(
                r[0] == TEXTURE_TYPES['mesh_attribute']
                for r in self.tex_rows),
            has_param_textures=any(
                r[2][16] > 0 or r[2][17] > 0 or r[2][18] > 0
                or (r[0] in (BSDF_TYPES['plastic'],
                             BSDF_TYPES['roughplastic'],
                             BSDF_TYPES['pplastic']) and r[2][15] >= 0)
                for r in self.bsdf_rows),
            spectral=bool(desc.get('spectral', False)),
            has_conductor_spd=has_cond_spd,
            measured_meta=tuple(mm for _, mm in self.measured),
            double=_wants_double(desc),
            sensor_type=sensor_type, film=film,
            sampler=sampler_desc.get('type', 'independent'), spp=spp,
            integrator=integ.get('type', 'path'),
            integrator_props=tuple(sorted(
                (k, _freeze(v)) for k, v in integ.items() if k != 'type')))
        return arrays, meta


def _freeze(v):
    """A hashable copy of an integrator property: nested dicts (the
    integrator a ``moment``, ``stokes`` or ``aov`` wraps) become sorted
    (key, value) tuples, lists tuples, as in the reference."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


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


def _wants_double(desc: dict) -> bool:
    """The double variant: ``desc['double']``, or ``MNT_DOUBLE=1`` in the
    environment, as the reference's ``build_scene`` reads them."""
    return bool(desc.get('double', False)) \
        or os.environ.get('MNT_DOUBLE', '') == '1'


def _flat_arrays(node, prefix='') -> dict:
    """A NamedTuple of tensors (tuples of them included) as {dotted
    field path: ndarray}, the keys ``scene_from_numpy`` reads."""
    out = {}
    items = (node._asdict().items() if hasattr(node, '_fields')
             else enumerate(node))
    for f, x in items:
        key = f'{prefix}{f}'
        if isinstance(x, tuple):
            out.update(_flat_arrays(x, key + '.'))
        else:
            out[key] = x.numpy()
    return out


def _measured_from_arrays(get, arrays) -> Tuple[tuple, tuple]:
    """(measured, measured_pol) tuples of a scene's arrays."""
    from ..bsdf.measured import MeasuredData
    from ..bsdf.measured_pol import MeasuredPolData

    def count(prefix):
        return sum(1 for k in arrays if k.startswith(prefix)
                   and k.endswith('.table' if 'pol' in prefix
                                  else '.ndf.data'))

    def marginal(p):
        n = sum(1 for k in arrays if k.startswith(p + '.param_values.'))
        return distr2d.Marginal2D(
            get(p + '.data'), get(p + '.marg_cdf'), get(p + '.cond_cdf'),
            tuple(get(f'{p}.param_values.{d}') for d in range(n)))
    measured = tuple(
        MeasuredData(**{f: marginal(f'measured.{k}.{f}')
                        for f in MeasuredData._fields})
        for k in range(count('measured.')))
    measured_pol = tuple(
        MeasuredPolData(**{f: get(f'measured_pol.{k}.{f}')
                           for f in MeasuredPolData._fields})
        for k in range(count('measured_pol.')))
    return measured, measured_pol


def scene_from_numpy(arrays: dict, meta: dict, device=None,
                     params: Optional[dict] = None
                     ) -> Tuple[SceneData, SceneMeta]:
    """Build the port's ``SceneData``/``SceneMeta`` from numpy arrays.

    ``arrays`` maps dotted field paths of the reference's ``SceneData``
    ("geo.v0", "emitters.em_tri_cdf", "sensor.to_world.m", ...) to numpy
    arrays; keys the port does not read are ignored. ``meta`` holds the
    fields of the reference's ``SceneMeta`` (``film`` as a dict).
    ``params``, a reference ``ParameterMap.to_dict()`` as numpy arrays,
    is loaded key for key through the port's ``ParameterMap`` after the
    build (its keys are the same dotted paths; a new density grid
    refreshes its derived arrays). Nothing here imports JAX: the caller
    flattens a reference scene into numpy first."""
    device = resolve_device(device)
    # the double variant: every float table in float64, as the
    # reference's build casts its scene under x64
    double = bool(meta.get('double')) \
        or np.asarray(arrays['geo.v0']).dtype == np.float64
    F = np.float64 if double else np.float32
    known = {f.name for f in fields(SceneMeta)}
    kw = {k: v for k, v in meta.items() if k in known}
    kw['film'] = FilmMeta(**{k: v for k, v in dict(meta['film']).items()
                             if k in ('width', 'height', 'rfilter')})
    for k in ('bsdf_types', 'emitter_types', 'medium_types', 'phase_types'):
        kw[k] = tuple(int(x) for x in kw.get(k, ()))
    kw['integrator_props'] = tuple(
        tuple(p) for p in kw.get('integrator_props', ()))
    kw['measured_meta'] = tuple(
        MeasuredMeta(bool(iso), bool(jac), int(red))
        for iso, jac, red in kw.get('measured_meta', ()))
    meta_t = SceneMeta(**kw)
    check_meta(meta_t)

    def get(key, dtype):
        a = np.asarray(arrays[key])
        return torch.as_tensor(np.array(a, dtype), device=device)

    def table(cls, prefix, dtypes):
        return cls(**{f: get(f'{prefix}.{f}', dtypes.get(f, F))
                      for f in cls._fields})

    def optional(key, dtype):
        return get(key, dtype) if arrays.get(key) is not None else ()

    i32 = np.int32
    geo = Geometry(**{f: get(f'geo.{f}', i32 if 'shape_idx' in f
                             else F)
                      for f in Geometry._fields if f not in ('c0', 'c1',
                                                             'c2')},
                   **{f: optional(f'geo.{f}', F)
                      for f in ('c0', 'c1', 'c2')})
    shapes = table(ShapeTable, 'shapes', {
        'bsdf_idx': i32, 'emitter_idx': i32, 'int_medium': i32,
        'ext_medium': i32})
    bsdfs = table(BSDFTable, 'bsdfs', {'type': i32, 'flags': i32})
    n_levels = sum(1 for k in arrays
                   if k.startswith('emitters.env_warp.levels.'))
    env_warp = distr2d.Hierarchical2D(
        nodes=get('emitters.env_warp.nodes', F),
        levels=tuple(get(f'emitters.env_warp.levels.{k}', F)
                     for k in range(n_levels)))
    emitters = EmitterTable(
        **{f: get(f'emitters.{f}', i32 if f in (
            'type', 'shape_idx', 'tri_offset', 'tri_count', 'em_tri_idx',
            'spec_kind')
            else F)
           for f in EmitterTable._fields
           if f not in ('env_warp', 'env_to_world')},
        env_warp=env_warp,
        env_to_world=Transform(get('emitters.env_to_world.m', F),
                               get('emitters.env_to_world.inv', F)))
    textures = TextureTable(
        type=get('textures.type', i32),
        params=get('textures.params', F),
        data=get('textures.data', F),
        size=get('textures.size', i32),
        vol=optional('textures.vol', F),
        vol_size=optional('textures.vol_size', i32))
    media = MediumTable(
        type=get('media.type', i32), phase_type=get('media.phase_type', i32),
        **{f: get(f'media.{f}', F)
           for f in ('params', 'grid_sigma_t', 'grid_sup', 'grid_sup_min',
                     'nl_ior')},
        nl_medium=get('media.nl_medium', i32),
        grid_sigma_p8=(get('media.grid_sigma_p8', F)
                       if arrays.get('media.grid_sigma_p8') is not None
                       else None),
        grid_albedo=(get('media.grid_albedo', F)
                     if arrays.get('media.grid_albedo') is not None
                     else None))
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
    to_world = Transform(get('sensor.to_world.m', F),
                         get('sensor.to_world.inv', F))
    sensor = SensorData(to_world=to_world, **{
        f: get(f'sensor.{f}', F)
        for f in SensorData._fields if f != 'to_world'})
    bvh = None
    if arrays.get('bvh.node_lo') is not None:
        bvh = bvh_mod.BVHArrays(**{
            f: get(f'bvh.{f}', dt) for f, dt in (
                ('node_lo', F), ('node_hi', F),
                ('node_a', i32), ('node_b', i32), ('node_leaf', bool),
                ('order', i32))})
    measured, measured_pol = _measured_from_arrays(
        lambda k: get(k, F), arrays)
    scene = SceneData(geo=geo, shapes=shapes, bsdfs=bsdfs, emitters=emitters,
                      media=media, occluders=occluders, textures=textures,
                      sensor=sensor, bvh=bvh, measured=measured,
                      measured_pol=measured_pol,
                      conductor_spd=(get('conductor_spd', F)
                                     if arrays.get('conductor_spd')
                                     is not None else ()),
                      **{k: get(k, F) for k in
                         ('bbox_lo', 'bbox_hi', 'bsphere_c', 'bsphere_r')})
    if params:
        from ..autodiff import ParameterMap
        pm = ParameterMap(scene)
        for k, v in params.items():
            if k not in pm:
                raise KeyError(f"'{k}' is not a differentiable parameter")
            pm[k] = np.asarray(v)
        scene = pm.scene
    return scene, meta_t


def build_scene(desc: dict, device=None) -> Tuple[SceneData, SceneMeta]:
    """Description dict -> (SceneData on ``device``, SceneMeta). The device
    defaults to CUDA; with no card, pass ``device='cpu'``."""
    device = resolve_device(device)
    arrays, meta = SceneBuilder(desc).build()
    return scene_from_numpy(arrays, meta, device)

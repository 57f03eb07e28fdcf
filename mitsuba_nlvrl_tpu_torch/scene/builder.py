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
become exact triangle pairs; spheres stay analytic unless emissive (area
emitters sample triangles, so an emissive sphere tessellates). Unlike the
reference, the builder keeps the input triangle order at every size and
builds no BVH: the dense intersection kernel is correct at any size, and
the BVH with its Morton order is a later slice (ROADMAP.md, B.2).
"""
from __future__ import annotations

from dataclasses import fields
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.transform import Transform
from .types import (SceneData, SceneMeta, FilmMeta, Geometry, ShapeTable,
                    BSDFTable, EmitterTable, SensorData, BSDF_NPARAM,
                    EMITTER_NPARAM, EMITTER_TYPES, SLICE_SHAPES,
                    check_meta, not_in_slice)
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..sensor import build_sensor


class MeshData(NamedTuple):
    vertices: np.ndarray            # (V, 3) float32
    faces: np.ndarray               # (F, 3) int32
    normals: Optional[np.ndarray]   # (V, 3) float32 per-vertex or None
    uvs: Optional[np.ndarray]       # (V, 2) float32 or None


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


def compute_vertex_normals(mesh: MeshData) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    n = np.zeros_like(v)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    return (n / ln).astype(np.float32)


def _load_shape_mesh(sh: dict) -> Optional[MeshData]:
    t = sh['type']
    if t not in SLICE_SHAPES:
        raise not_in_slice(f"shape type '{t}'", "item 4 (scene front-end)")
    if t == 'sphere':
        if sh.get('emitter') is None:
            return None   # analytic
        mesh = icosphere_mesh()
        c = np.asarray(sh.get('center', (0, 0, 0)), np.float32)
        r = float(sh.get('radius', 1.0))
        return MeshData(mesh.vertices * r + c, mesh.faces, mesh.normals, None)
    mesh = _rectangle_mesh() if t == 'rectangle' else _cube_mesh()
    if sh.get('face_normals', False):
        mesh = mesh._replace(normals=None)
    return mesh


class SceneBuilder:
    def __init__(self, desc: dict):
        self.desc = desc
        self.bsdf_rows: List[Tuple[int, int, list]] = []

    def _bsdf_index(self, props: Optional[dict]) -> int:
        # One row per shape, shared dicts included: the reference's table
        # has the same rows (its id-keyed cache is written under another
        # key and never hits), so both packages index alike.
        self.bsdf_rows.append(bsdf_mod.pack_params(props or
                                                   {'type': 'diffuse'}))
        return len(self.bsdf_rows) - 1

    def build(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """Returns (arrays, meta) in the form ``scene_from_numpy`` takes."""
        desc = self.desc
        if desc.get('spectral') or desc.get('double'):
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
        shape_rows = []     # (bsdf, emitter)
        area_emitters = []  # (props, shape_idx)
        shape_tri_ranges = []
        for sh in desc.get('shapes', []):
            if sh.get('type') in ('instance', 'shapegroup'):
                raise not_in_slice("shape instancing",
                                   "item 4 (scene front-end)")
            if sh.get('interior') is not None \
                    or sh.get('exterior') is not None:
                raise not_in_slice("participating media",
                                   "item 8 (volumetrics)")
            to_world = sh.get('to_world', Transform.identity())
            shape_idx = len(shape_rows)
            mesh = _load_shape_mesh(sh)
            bsdf_idx = self._bsdf_index(sh.get('bsdf'))
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
            shape_rows.append([bsdf_idx, emitter_idx])

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

        # --- emitters: area emitters first (their index is list position) --
        emitter_rows = []       # (type, params, shape_idx)
        em_tri_idx, em_tri_cdf, em_area = [], [], []
        tri_offsets, tri_counts = [], []
        for props, shape_idx in area_emitters:
            code, params = emitter_mod.pack_params(props)
            start, count = shape_tri_ranges[shape_idx]
            idxs = np.arange(start, start + count, dtype=np.int32)
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

        sr = np.asarray(shape_rows, np.int32).reshape(-1, 2)
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

        integ = desc.get('integrator', {'type': 'path'})
        meta = dict(
            n_tris=T, n_spheres=len(sph_c), n_shapes=len(shape_rows),
            n_bsdfs=len(btype), n_emitters=E,
            bsdf_types=tuple(sorted(set(int(x) for x in btype))),
            emitter_types=tuple(sorted(set(int(r[0])
                                           for r in emitter_rows))),
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
    'n_media': "item 8 (volumetrics)", 'has_media': "item 8 (volumetrics)",
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
    for k in ('bsdf_types', 'emitter_types'):
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
    shapes = table(ShapeTable, 'shapes', {'bsdf_idx': i32,
                                          'emitter_idx': i32})
    bsdfs = table(BSDFTable, 'bsdfs', {'type': i32, 'flags': i32})
    emitters = table(EmitterTable, 'emitters', {
        'type': i32, 'shape_idx': i32, 'tri_offset': i32, 'tri_count': i32,
        'em_tri_idx': i32})
    to_world = Transform(get('sensor.to_world.m', np.float32),
                         get('sensor.to_world.inv', np.float32))
    sensor = SensorData(to_world=to_world, **{
        f: get(f'sensor.{f}', np.float32)
        for f in SensorData._fields if f != 'to_world'})
    scene = SceneData(geo=geo, shapes=shapes, bsdfs=bsdfs, emitters=emitters,
                      sensor=sensor,
                      **{k: get(k, np.float32) for k in
                         ('bbox_lo', 'bbox_hi', 'bsphere_c', 'bsphere_r')})
    return scene, meta_t


def build_scene(desc: dict, device=None) -> Tuple[SceneData, SceneMeta]:
    """Description dict -> (SceneData on ``device``, SceneMeta). The device
    defaults to CUDA; with no card, pass ``device='cpu'``."""
    device = resolve_device(device)
    arrays, meta = SceneBuilder(desc).build()
    return scene_from_numpy(arrays, meta, device)

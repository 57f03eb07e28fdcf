"""The port's mesh loaders against the reference's: seeded meshes written
as OBJ (quads, negative indices, vt/vn), PLY (ASCII, binary little- and
big-endian) and Mitsuba .serialized load to the same arrays in both
packages, exactly."""
import struct
import zlib

import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.scene import mesh_io as J
from mitsuba_nlvrl_tpu_torch.scene import mesh_io as P

torch.set_num_threads(1)   # one intra-op thread a test worker


def _mesh(seed, n_verts=40, n_quads=30, n_tris=20):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-2, 2, (n_verts, 3)).astype(np.float32)
    n = rng.normal(size=(n_verts, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (n_verts, 2)).astype(np.float32)
    quads = rng.integers(0, n_verts, (n_quads, 4))
    tris = rng.integers(0, n_verts, (n_tris, 3))
    return v, n, uv, quads, tris


def assert_same_mesh(p, j):
    assert type(p).__name__ == type(j).__name__ == 'MeshData'
    for f in j._fields:
        a, b = getattr(p, f), getattr(j, f)
        if b is None or isinstance(b, dict):
            assert (a is None and b is None) or a.keys() == b.keys(), f
            for k in (b or {}):
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _f(x):
    return repr(float(x))


def test_obj_quads_negative_indices_and_attributes(tmp_path):
    v, n, uv, quads, tris = _mesh(1)
    lines = [f'v {_f(a)} {_f(b)} {_f(c)}' for a, b, c in v]
    lines += [f'vt {_f(a)} {_f(b)}' for a, b in uv]
    lines += [f'vn {_f(a)} {_f(b)} {_f(c)}' for a, b, c in n]
    lines.append('# a comment, then quads with v/vt/vn, negative indices')
    nv = len(v)
    for q in quads:
        lines.append('f ' + ' '.join(f'{i + 1}/{i + 1}/{i - nv}' for i in q))
    lines.append('g second')
    for t in tris:   # position-only and v//vn corners
        lines.append(f'f {t[0] - nv} {t[1] + 1}//{t[1] + 1} {t[2] + 1}')
    path = tmp_path / 'm.obj'
    path.write_text('\n'.join(lines) + '\n')
    mp, mj = P.load_obj(str(path)), J.load_obj(str(path))
    assert_same_mesh(mp, mj)
    assert len(mp.faces) == 2 * len(quads) + len(tris)
    assert_same_mesh_normals(mp, mj)


def assert_same_mesh_normals(mp, mj):
    np.testing.assert_array_equal(P.compute_vertex_normals(mp),
                                  J.compute_vertex_normals(mj))


def _ply_header(fmt, nv, nf, extra_face=False):
    h = [f'ply', f'format {fmt} 1.0', 'comment seeded test mesh',
         f'element vertex {nv}', 'property float x', 'property float y',
         'property float z', 'property float nx', 'property float ny',
         'property float nz', 'property float u', 'property float v',
         'property uchar red', 'property uchar green', 'property uchar blue',
         f'element face {nf}', 'property list uchar int vertex_indices']
    if extra_face:
        h.append('property float weight')
    return '\n'.join(h + ['end_header']) + '\n'


@pytest.mark.parametrize('fmt', ['ascii', 'binary_little_endian',
                                 'binary_big_endian'])
def test_ply_formats(tmp_path, fmt):
    v, n, uv, quads, _ = _mesh(2)
    rng = np.random.default_rng(5)
    col = rng.integers(0, 256, (len(v), 3))
    w = rng.uniform(0, 1, len(quads)).astype(np.float32)
    path = tmp_path / 'm.ply'
    head = _ply_header(fmt, len(v), len(quads), extra_face=True)
    if fmt == 'ascii':
        rows = [' '.join([_f(x) for x in (*v[i], *n[i], *uv[i])]
                         + [str(c) for c in col[i]]) for i in range(len(v))]
        rows += [' '.join(['4'] + [str(i) for i in q] + [_f(wq)])
                 for q, wq in zip(quads, w)]
        path.write_text(head + '\n'.join(rows) + '\n')
    else:
        e = '<' if 'little' in fmt else '>'
        vdt = np.dtype([(k, e + 'f4') for k in
                        ('x', 'y', 'z', 'nx', 'ny', 'nz', 'u', 'v')]
                       + [(k, 'u1') for k in ('red', 'green', 'blue')])
        vert = np.zeros(len(v), vdt)
        for i, k in enumerate(('x', 'y', 'z')):
            vert[k] = v[:, i]
            vert['n' + k] = n[:, i]
        vert['u'], vert['v'] = uv[:, 0], uv[:, 1]
        for i, k in enumerate(('red', 'green', 'blue')):
            vert[k] = col[:, i]
        fdt = np.dtype([('n', 'u1'), ('i', e + 'i4', (4,)),
                        ('weight', e + 'f4')])
        face = np.zeros(len(quads), fdt)
        face['n'], face['i'], face['weight'] = 4, quads, w
        path.write_bytes(head.encode() + vert.tobytes() + face.tobytes())
    mp, mj = P.load_ply(str(path)), J.load_ply(str(path))
    assert_same_mesh(mp, mj)
    assert len(mp.faces) == 2 * len(quads) and mp.colors is not None
    assert_same_mesh_normals(mp, mj)


def _serialized(meshes, version=4) -> bytes:
    """A Mitsuba .serialized file holding ``meshes`` [(v, n, uv, f)]."""
    out, offsets = b'', []
    for k, (v, n, uv, f) in enumerate(meshes):
        flags = 0x1000 | (0x1 if n is not None else 0) \
            | (0x2 if uv is not None else 0)
        body = struct.pack('<I', flags)
        if version >= 4:
            body += f'mesh{k}'.encode() + b'\0'
        body += struct.pack('<QQ', len(v), len(f))
        for a in (v, n, uv):
            if a is not None:
                body += np.ascontiguousarray(a, '<f4').tobytes()
        body += np.ascontiguousarray(f, '<u4').tobytes()
        offsets.append(len(out))
        out += struct.pack('<HH', 0x041C, version) + zlib.compress(body)
    osize = '<Q' if version >= 4 else '<I'
    return out + b''.join(struct.pack(osize, o) for o in offsets) \
        + struct.pack('<I', len(meshes))


@pytest.mark.parametrize('version', [3, 4])
def test_serialized_shape_index(tmp_path, version):
    v, n, uv, _, tris = _mesh(3)
    v2, _, uv2, _, tris2 = _mesh(4, n_verts=25, n_tris=31)
    path = tmp_path / 'm.serialized'
    path.write_bytes(_serialized([(v, n, uv, tris), (v2, None, uv2, tris2)],
                                 version))
    for idx in (0, 1):
        mp = P.load_serialized(str(path), idx)
        mj = J.load_serialized(str(path), idx)
        assert_same_mesh(mp, mj)
    assert len(mp.faces) == len(tris2) and mp.normals is None
    with pytest.raises(ValueError):
        P.load_serialized(str(path), 2)


def test_blender_arrays(tmp_path):
    rng = np.random.default_rng(7)
    verts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    loops = rng.integers(0, 30, 90)
    props = {'verts': verts,
             'vert_normals': rng.normal(size=(30, 3)).astype(np.float32),
             'loops': loops, 'loop_tris': np.arange(90).reshape(30, 3),
             'loop_tri_polys': np.arange(30) // 2,
             'poly_smooth': rng.integers(0, 2, 15).astype(bool),
             'poly_mat': rng.integers(0, 2, 15), 'mat_nr': 1,
             'uvs': rng.uniform(0, 1, (90, 2)),
             'cols': rng.integers(0, 256, (90, 4))}
    assert_same_mesh(P.load_blender(props), J.load_blender(props))

"""The port's textures against the reference's: ``pack`` rows, ``eval``
of the six types, ``vertex_attr`` on mesh hits, the port's PNG reader
against PIL (the reference's decoder) and ``load_bitmap`` against the
reference's on PNG and EXR (JPEG: ``tests/test_torch_jpeg.py``).

Tolerances: rows, decoded samples and loaded bitmaps equal; ``eval``
1e-6 relative with an absolute floor of 1e-6 (a grid3d lookup maps the
hit point by a 3x4 product that the reference's einsum sums in its own
order); ``vertex_attr`` 1e-5 (it solves the barycentrics from the hit
point)."""
import struct
import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu.scene import types as jtypes
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.core.ray import Ray
from mitsuba_nlvrl_tpu_torch.scene import builder as pbuilder
from mitsuba_nlvrl_tpu_torch.scene import types as ptypes
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes
from mitsuba_nlvrl_tpu_torch.utils.io import read_png, write_exr

torch.set_num_threads(1)   # one intra-op thread a test worker

N = 4096


# --- a PNG encoder with every row filter, for the reader's tests ------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prior, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _sample_rows(samples, depth):
    """(H, stride) bytes of (H, W, C) samples, sub-byte samples packed
    from the high bits."""
    H, W = samples.shape[:2]
    if depth == 16:
        return samples.astype('>u2').reshape(H, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(H, -1)
    per = 8 // depth
    flat = samples.reshape(H, W).astype(np.uint8)
    pad = np.zeros((H, -W % per), np.uint8)
    flat = np.concatenate([flat, pad], 1).reshape(H, -1, per)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (flat << shifts).sum(-1).astype(np.uint8)


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_test_png(path, samples, ctype, depth, palette=None, trns=None,
                   interlace=False):
    """A PNG of (H, W, C) samples (indices for a palette), its rows
    cycling through the five filters; with ``interlace`` Adam7, each pass
    filtered as an image of its own and empty passes left out."""
    H, W = samples.shape[:2]
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, chans * depth // 8)
    passes = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
              if interlace else [samples])
    raw = b''
    for sub in passes:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _sample_rows(sub, depth)
        prior = bytes(rows.shape[1])
        for y in range(rows.shape[0]):
            row = rows[y].tobytes()
            raw += _filter_row(y % 5, row, prior, bpp)
            prior = row

    def chunk(tag, body):
        return struct.pack('>I', len(body)) + tag + body + struct.pack(
            '>I', zlib.crc32(tag + body) & 0xFFFFFFFF)
    data = b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
        '>IIBBBBB', W, H, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b'PLTE', palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b'tRNS', trns.astype(np.uint8).tobytes())
    data += chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b'')
    with open(path, 'wb') as f:
        f.write(data)


# (colour type, bit depth, palette, transparency)
PNG_KINDS = {
    'grey8': (0, 8, False, False), 'grey16': (0, 16, False, False),
    'grey4': (0, 4, False, False), 'grey1': (0, 1, False, False),
    'rgb8': (2, 8, False, False), 'rgb16': (2, 16, False, False),
    'palette8': (3, 8, True, False), 'palette4_trns': (3, 4, True, True),
    'palette8_trns': (3, 8, True, True),
    'grey_alpha8': (4, 8, False, False), 'grey_alpha16': (4, 16, False,
                                                          False),
    'rgba8': (6, 8, False, False), 'rgba16': (6, 16, False, False),
}


def _png(tmp_path, kind, seed=0, size=(13, 29), interlace=False,
         name=None):
    ctype, depth, pal, trns = PNG_KINDS[kind]
    rng = np.random.default_rng(seed)
    H, W = size          # odd sizes: sub-byte rows end mid-byte
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    hi = (1 << depth) - 1 if ctype != 3 else (1 << depth) - 1
    samples = rng.integers(0, hi + 1, (H, W, chans))
    palette = rng.integers(0, 256, (1 << depth, 3)) if pal else None
    alpha = rng.integers(0, 256, (1 << depth) - 3) if trns else None
    path = str(tmp_path / f'{name or kind}.png')
    write_test_png(path, samples, ctype, depth, palette, alpha, interlace)
    return path


@pytest.mark.parametrize('kind', list(PNG_KINDS))
def test_read_png_matches_pil(kind, tmp_path):
    path = _png(tmp_path, kind)
    got = read_png(path)
    im = Image.open(path)
    if im.mode == 'P':
        ref = np.asarray(im.convert('RGBA' if 'trns' in kind else 'RGB'))
    elif im.mode == '1':
        ref = np.asarray(im).astype(np.uint8)[..., None] * 255
    else:
        ref = np.asarray(im)
        if ref.ndim == 2:
            ref = ref[..., None]
        if PNG_KINDS[kind][1] == 16 and PNG_KINDS[kind][0] != 0:
            got = got >> 8      # PIL keeps the high byte of 16-bit colour
        if kind == 'grey_alpha16':
            got = got[..., [0, 0, 0, 1]]    # and opens grey+alpha as RGBA
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert (got.astype(np.int64) == ref.astype(np.int64)).all()


@pytest.mark.parametrize('raw', [False, True])
@pytest.mark.parametrize('kind', ['rgb8', 'grey16', 'palette4_trns',
                                  'rgba16', 'grey_alpha8', 'grey_alpha16'])
def test_load_bitmap_png_matches_reference(kind, raw, tmp_path):
    path = _png(tmp_path, kind, seed=1)
    got = ptex.load_bitmap(path, gamma=not raw)
    ref = jtex.load_bitmap(path, gamma=not raw)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize('interlace', [False, True])
@pytest.mark.parametrize('size', [(1, 1), (3, 5), (9, 17)])
@pytest.mark.parametrize('kind', ['rgb8', 'rgb16', 'rgba8', 'rgba16',
                                  'grey8', 'grey_alpha8', 'palette8_trns',
                                  'palette4_trns'])
def test_load_bitmap_adam7_png_matches_reference(kind, size, interlace,
                                                 tmp_path):
    """Adam7-interlaced and plain files of the same samples: the port's
    load_bitmap equals the reference's (PIL's decode) on each, and the
    port reads both to the same samples. At 1x1 and 3x5 some of the
    seven passes hold no pixel."""
    path = _png(tmp_path, kind, seed=3, size=size, interlace=interlace)
    got = ptex.load_bitmap(path)
    ref = jtex.load_bitmap(path)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == (*size, 3)
    assert got.tobytes() == ref.tobytes()
    plain = _png(tmp_path, kind, seed=3, size=size, name='plain')
    samples = read_png(path)
    assert samples.dtype == read_png(plain).dtype
    assert np.array_equal(samples, read_png(plain))


def test_load_bitmap_exr_matches_reference(tmp_path):
    img = np.random.default_rng(2).uniform(0, 4, (9, 17, 3)).astype(
        np.float32)
    path = str(tmp_path / 'a.exr')
    write_exr(path, img)
    got = ptex.load_bitmap(path)
    assert got.tobytes() == jtex.load_bitmap(path).tobytes()
    assert got.tobytes() == img.tobytes()


def test_progressive_jpeg_bitmap_raises_naming_its_roadmap_entry(tmp_path):
    """A progressive JPEG loads as the reference loads it (more kinds:
    ``tests/test_torch_jpeg.py``); a kind still left out, an
    arithmetic-coded frame, raises naming its ROADMAP entry."""
    path = str(tmp_path / 'a.jpg')
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (9, 10, 3), dtype=np.uint8)).save(path, progressive=True)
    assert ptex.load_bitmap(path).tobytes() == \
        jtex.load_bitmap(path).tobytes()
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    data[data.find(b'\xff\xc2') + 1] = 0xCA          # SOF10
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match=r'item 12\.6 .*JPEG'):
        ptex.load_bitmap(path)


# --- pack and eval ------------------------------------------------------------

def _tex_props(tmp_path):
    path = _png(tmp_path, 'rgb8', seed=3)
    grid = np.random.default_rng(4).uniform(0, 1, (5, 6, 7, 3)).astype(
        np.float32)
    return {
        'bitmap': {'type': 'bitmap', 'filename': path, 'uscale': 2.0,
                   'vscale': 0.5},
        'checkerboard': {'type': 'checkerboard', 'color0': (0.9, 0.1, 0.2),
                         'color1': 0.3, 'uscale': 3.0, 'vscale': 5.0},
        'constant': {'type': 'constant', 'value': (0.2, 0.4, 0.6)},
        'grid3d': {'type': 'grid3d', 'grid': grid, 'bbox_min': (-1, -1, -1),
                   'bbox_max': (1, 0.5, 2), 'scale': 1.5},
        'constant3d': {'type': 'constant3d', 'color': (0.7, 0.5, 0.3)},
        'mesh_attribute': {'type': 'mesh_attribute', 'name': 'vertex_color',
                           'scale': 0.8},
    }


@pytest.mark.parametrize('name', list(ptypes.TEXTURE_TYPES))
def test_pack_rows_match_reference(name, tmp_path):
    props = _tex_props(tmp_path)[name]
    bj, vj, bp, vp = [], [], [], []
    code_j, row_j = jtex.pack(props, bj, vj)
    code_p, row_p = ptex.pack(props, bp, vp)
    assert code_p == code_j == ptypes.TEXTURE_TYPES[name]
    assert np.float32(row_p).tobytes() == np.float32(row_j).tobytes()
    assert len(bp) == len(bj) and len(vp) == len(vj)
    for a, b in zip(bp + vp, bj + vj):
        assert a.tobytes() == b.tobytes()


def _tables(tmp_path):
    """The six textures in one table, as each package holds it."""
    rows, bitmaps, volumes = [], [], []
    for props in _tex_props(tmp_path).values():
        rows.append(ptex.pack(props, bitmaps, volumes))
    arrays = pbuilder._texture_arrays(rows, bitmaps, volumes)
    fields = {k.split('.', 1)[1]: v for k, v in arrays.items()}
    tj = jtypes.TextureTable(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = ptypes.TextureTable(**{k: torch.from_numpy(v)
                                for k, v in fields.items()})
    return SimpleNamespace(textures=tj), SimpleNamespace(textures=tp)


@pytest.mark.parametrize('name', list(ptypes.TEXTURE_TYPES))
def test_eval_matches_reference(name, tmp_path):
    sj, sp = _tables(tmp_path)
    rng = np.random.default_rng(6)
    tid = np.full(N, list(ptypes.TEXTURE_TYPES).index(name), np.int32)
    tid[::17] = -1                          # untextured lanes read zeros
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    p = rng.uniform(-1.3, 2.3, (N, 3)).astype(np.float32)
    attr = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ref = np.asarray(jtex.eval(sj, jnp.asarray(tid), jnp.asarray(uv),
                               p_world=jnp.asarray(p),
                               attr=jnp.asarray(attr)))
    got = ptex.eval(sp, torch.from_numpy(tid), torch.from_numpy(uv),
                    p_world=torch.from_numpy(p),
                    attr=torch.from_numpy(attr)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (got[::17] == 0).all() and np.abs(got).max() > 0


def test_vertex_attr_on_mesh_hits(tmp_path):
    """The colour interpolated at the hits of camera rays on a vertex-
    coloured PLY, beside an analytic sphere (whose hits read zeros)."""
    ply = str(tmp_path / 'ico.ply')
    pscenes.colored_icosphere_ply(ply, subdiv=1)
    d = pscenes.cornell_box(spp=1, res=8)
    d['shapes'] = [
        {'type': 'ply', 'filename': ply, 'bsdf': {
            'type': 'diffuse', 'reflectance': {'type': 'mesh_attribute'}},
         'to_world': pscenes.tr.translate((0.4, 0, 0)) @ pscenes.tr.scale(
             0.5)},
        {'type': 'sphere', 'center': (-0.5, 0, 0), 'radius': 0.3}]
    sp, mp = P.build_scene(d, device='cpu')
    assert mp.has_attr_textures
    rng = np.random.default_rng(7)
    o = np.zeros((N, 3), np.float32)
    o[:, 2] = -3.0
    tgt = rng.uniform(-1, 1, (N, 3)).astype(np.float32) * (1, 0.7, 0)
    dirs = tgt - o
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    si = pisect.ray_intersect(sp, Ray.make(torch.from_numpy(o),
                                           torch.from_numpy(dirs)))
    got = ptex.vertex_attr(sp, si).numpy()
    geo = SimpleNamespace(**{f: jnp.asarray(getattr(sp.geo, f).numpy())
                             for f in ('v0', 'e1', 'e2', 'c0', 'c1', 'c2',
                                       'shape_idx')})
    si_j = SimpleNamespace(**{f: jnp.asarray(getattr(si, f).numpy())
                              for f in ('p', 'prim_index', 'valid',
                                        'shape_idx')})
    ref = np.asarray(jtex.vertex_attr(SimpleNamespace(geo=geo), si_j))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    on_mesh = si.valid.numpy() & (si.shape_idx.numpy() == 0)
    assert on_mesh.sum() > 100 and (got[on_mesh].sum(1) > 0).all()
    assert (got[~on_mesh] == 0).all()

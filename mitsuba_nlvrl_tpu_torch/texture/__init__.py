"""Textures: bitmap, checkerboard, constant, grid3d, constant3d and
mesh_attribute.

Port of ``mitsuba_nlvrl_tpu/texture/__init__.py``: per-lane texture ids
gather from a stack of bitmaps padded to the largest one (bilinear,
wrapping in u); checkerboards and constants evaluate procedurally;
``grid3d`` trilerps a volume at the world hit position; ``mesh_attribute``
interpolates the per-corner colours of the hit triangle. ``pack`` (host
side) makes a texture's row and loads its bitmap or volume.

Bitmaps load without PIL: PNG through ``utils/io.read_png``, baseline
JPEG through ``utils/io.read_jpeg``, EXR through ``utils/io.read_exr``; a
JPEG beyond baseline or any other format raises, naming its ROADMAP
entry. Lanes whose row is not a bitmap or a volume read a
clamped, valid index (the reference relies on JAX clamping there); their
value is masked out.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..scene.types import TEXTURE_TYPES, TEX_NPARAM, not_in_slice


def _pil_rgb(img: np.ndarray) -> np.ndarray:
    """The 8-bit RGB that the reference's ``Image.convert('RGB')`` makes
    of a PNG's samples: alpha dropped, grey replicated; 16-bit colour and
    grey-alpha keep their high byte, and 16-bit grey clips at 255 (PIL
    opens it as 32-bit integers)."""
    c = img.shape[-1]
    col = img[..., :1] if c <= 2 else img[..., :3]
    if img.dtype == np.uint16:
        col = np.minimum(col, 255) if c == 1 else col >> 8
    col = col.astype(np.uint8)
    return np.repeat(col, 3, axis=-1) if col.shape[-1] == 1 else col


def load_bitmap(path: str, gamma: bool = True) -> np.ndarray:
    """Load an image file to linear float32 (H, W, 3)."""
    if path.lower().endswith('.exr'):
        from ..utils.io import read_exr
        img, names = read_exr(path)
        if set('RGB') <= set(names):
            img = img[:, :, [names.index(c) for c in 'RGB']]
        return np.ascontiguousarray(img[:, :, :3], np.float32)
    with open(path, 'rb') as f:
        magic = f.read(8)
    if magic[:2] == b'\xff\xd8':
        from ..utils.io import read_jpeg
        rgb8 = read_jpeg(path)
    elif magic == b'\x89PNG\r\n\x1a\n':
        from ..utils.io import read_png
        rgb8 = _pil_rgb(read_png(path))
    else:
        raise not_in_slice(f"bitmap '{path}' (neither PNG, JPEG nor EXR)",
                           "item 12.7 (other bitmap formats)")
    img = np.asarray(rgb8, np.float32) / 255.0
    if gamma:  # sRGB -> linear
        img = np.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)
    return img.astype(np.float32)


def pack(props: dict, bitmaps: list, volumes: list = None
         ) -> Tuple[int, list]:
    """Returns (type_code, params); appends loaded bitmaps and volumes to
    the given lists. Checkerboard rows: color0 [0:3], color1 [3:6], uv
    scale [6:8]; bitmap: its slot [0], uv scale [6:8]; grid3d: its volume
    slot [0], the world-to-unit-cube 3x4 map [8:20], scale [20];
    constant and constant3d: the value [0:3]; mesh_attribute: scale [20].
    Any other type packs as a constant, as in the reference."""
    t = props.get('type', 'constant')
    p = [0.0] * TEX_NPARAM

    def rgb(key, default):
        v = props.get(key, default)
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    if t == 'grid3d' or (t == 'gridvolume' and volumes is not None):
        # evaluated at the world hit position: the row maps world space
        # into the grid's unit cube
        from ..scene.vol_io import load_vol
        if 'grid' in props:          # an array given directly
            data = np.asarray(props['grid'], np.float32)
            bb_lo = np.asarray(props.get('bbox_min', (0, 0, 0)), np.float32)
            bb_hi = np.asarray(props.get('bbox_max', (1, 1, 1)), np.float32)
        else:
            vg = load_vol(props['filename'])
            data, bb_lo, bb_hi = vg.data, vg.bbox_min, vg.bbox_max
        if data.ndim == 3:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        tw = props.get('to_world')
        M = np.asarray(tw.m) if tw is not None else np.eye(4)
        Minv = np.linalg.inv(M)
        ext = np.maximum(bb_hi - bb_lo, 1e-12)
        # p_unit = (Minv @ p_world - bb_lo) / ext, folded into one 3x4
        A = Minv[:3, :3] / ext[:, None]
        b = (Minv[:3, 3] - bb_lo) / ext
        p[0] = len(volumes)
        p[8:20] = np.concatenate([A, b[:, None]], axis=1).reshape(-1)
        p[20] = float(props.get('scale', 1.0))
        volumes.append(data[..., :3].astype(np.float32))
        return TEXTURE_TYPES['grid3d'], p
    if t == 'constant3d':
        p[0:3] = rgb('value', rgb('color', 0.5))
        return TEXTURE_TYPES['constant3d'], p
    if t == 'mesh_attribute':
        p[20] = float(props.get('scale', 1.0))
        return TEXTURE_TYPES['mesh_attribute'], p
    if t == 'bitmap':
        img = load_bitmap(props['filename'],
                          gamma=props.get('raw', False) is False)
        p[0] = len(bitmaps)        # bitmap slot
        p[6] = float(props.get('uscale', 1.0))
        p[7] = float(props.get('vscale', 1.0))
        bitmaps.append(img)
        return TEXTURE_TYPES['bitmap'], p
    if t == 'checkerboard':
        p[0:3] = rgb('color0', 0.4)
        p[3:6] = rgb('color1', 0.2)
        p[6] = float(props.get('uscale', 1.0))
        p[7] = float(props.get('vscale', 1.0))
        return TEXTURE_TYPES['checkerboard'], p
    p[0:3] = rgb('value', 0.5)
    return TEXTURE_TYPES['constant'], p


def vertex_attr(scene, si):
    """The per-corner colour interpolated at a surface hit. The hit
    record has no barycentrics, so they are solved from the hit position
    (the 2x2 normal equations of p - v0 = u e1 + v e2). Lanes whose
    primitive is not a triangle of the hit shape (spheres, misses) or
    whose point is off its plane give zeros."""
    geo = scene.geo
    if not isinstance(getattr(geo, 'c0', ()), torch.Tensor):
        return torch.zeros(si.p.shape, device=si.p.device)
    T = geo.v0.shape[0]
    idx = torch.clamp(si.prim_index.long(), 0, max(T - 1, 0))
    v0 = geo.v0[idx]
    e1 = geo.e1[idx]
    e2 = geo.e2[idx]
    d = si.p - v0
    a11 = torch.sum(e1 * e1, -1)
    a12 = torch.sum(e1 * e2, -1)
    a22 = torch.sum(e2 * e2, -1)
    b1 = torch.sum(d * e1, -1)
    b2 = torch.sum(d * e2, -1)
    det = torch.clamp(a11 * a22 - a12 * a12, min=1e-18)
    u = (a22 * b1 - a12 * b2) / det
    v = (a11 * b2 - a12 * b1) / det
    w = 1.0 - u - v
    col = (w[:, None] * geo.c0[idx] + u[:, None] * geo.c1[idx]
           + v[:, None] * geo.c2[idx])
    recon = v0 + u[:, None] * e1 + v[:, None] * e2
    on_tri = (torch.sum((recon - si.p) ** 2, -1)
              <= 1e-6 * torch.maximum(a11, a22))
    ok = si.valid & (geo.shape_idx[idx] == si.shape_idx) & on_tri
    return torch.where(ok[:, None], col, 0.0)


def eval(scene, tex_id, uv, p_world=None, attr=None):
    """Per-lane texture lookup: tex_id (N,) int (-1 -> zeros), uv (N, 2).
    ``p_world`` enables the grid3d rows, ``attr`` (the interpolated
    vertex colour) the mesh_attribute rows. Returns (N, 3)."""
    tt = scene.textures
    tid = torch.clamp(tex_id.long(), min=0)
    ttype = tt.type[tid]
    P = tt.params[tid]
    us = P[:, 6]
    vs = P[:, 7]
    u = uv[:, 0] * torch.where(us != 0, us, 1.0)
    v = uv[:, 1] * torch.where(vs != 0, vs, 1.0)

    out = P[:, 0:3]  # constant, and a checkerboard's color0

    # checkerboard: parity of floor(2u) + floor(2v)
    par = (torch.floor(u * 2.0).to(torch.int32)
           + torch.floor(v * 2.0).to(torch.int32)) & 1
    chk = torch.where((par == 0)[:, None], P[:, 0:3], P[:, 3:6])
    out = torch.where((ttype == TEXTURE_TYPES['checkerboard'])[:, None],
                      chk, out)

    if tt.data.shape[0] > 0 and tt.data.shape[1] > 1:
        nb, Hm, Wm = tt.data.shape[0], tt.data.shape[1], tt.data.shape[2]
        slot = torch.clamp(P[:, 0].to(torch.int64), 0, nb - 1)
        H = tt.size[tid, 0].long()
        W = tt.size[tid, 1].long()
        # bilinear with wrap in u, flip v (image row 0 = top, v=0 bottom)
        x = torch.remainder(u, 1.0) * W.to(torch.float32) - 0.5
        y = (1.0 - torch.remainder(v, 1.0)) * H.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        tx = x - x0
        ty = y - y0

        def at(yy, xx):
            # the reference's clip(yy, 0, H - 1); rows that are not
            # bitmaps (H = W = 0) read texel (0, 0)
            yy = torch.clamp(torch.minimum(torch.clamp(yy, min=0), H - 1),
                             0, Hm - 1)
            xx = torch.clamp(torch.remainder(xx, torch.clamp(W, min=1)),
                             0, Wm - 1)
            return tt.data[slot, yy, xx]

        bil = (at(y0, x0) * ((1 - tx) * (1 - ty))[:, None]
               + at(y0, x0 + 1) * (tx * (1 - ty))[:, None]
               + at(y0 + 1, x0) * ((1 - tx) * ty)[:, None]
               + at(y0 + 1, x0 + 1) * (tx * ty)[:, None])
        out = torch.where((ttype == TEXTURE_TYPES['bitmap'])[:, None], bil,
                          out)

    # grid3d: trilerp the volume at the world-to-unit-cube mapped position
    vol = getattr(tt, 'vol', ())
    if p_world is not None and isinstance(vol, torch.Tensor) \
            and vol.ndim == 5:
        A = P[:, 8:20].reshape(-1, 3, 4)
        lp = (A[:, :, 0] * p_world[:, 0:1] + A[:, :, 1] * p_world[:, 1:2]
              + A[:, :, 2] * p_world[:, 2:3]) + A[:, :, 3]
        slot = torch.clamp(P[:, 0].to(torch.int64), 0, vol.shape[0] - 1)
        D = tt.vol_size[tid, 0].to(torch.float32)
        Hh = tt.vol_size[tid, 1].to(torch.float32)
        Ww = tt.vol_size[tid, 2].to(torch.float32)
        inside = torch.all((lp >= 0.0) & (lp <= 1.0), dim=-1)
        # voxel-centre sampling, like the medium grids
        fx = torch.clamp(torch.clamp(lp[:, 0] * Ww - 0.5, min=0.0),
                         max=Ww - 1.0)
        fy = torch.clamp(torch.clamp(lp[:, 1] * Hh - 0.5, min=0.0),
                         max=Hh - 1.0)
        fz = torch.clamp(torch.clamp(lp[:, 2] * D - 0.5, min=0.0),
                         max=D - 1.0)
        x0 = fx.to(torch.int64)
        y0 = fy.to(torch.int64)
        z0 = fz.to(torch.int64)
        txf, tyf, tzf = fx - x0, fy - y0, fz - z0
        xm, ym, zm = ((s - 1.0).to(torch.int64) for s in (Ww, Hh, D))
        acc = 0.0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    w = ((txf if dx else 1 - txf) * (tyf if dy else 1 - tyf)
                         * (tzf if dz else 1 - tzf))
                    xi = torch.clamp(torch.minimum(x0 + dx, xm), 0,
                                     vol.shape[3] - 1)
                    yi = torch.clamp(torch.minimum(y0 + dy, ym), 0,
                                     vol.shape[2] - 1)
                    zi = torch.clamp(torch.minimum(z0 + dz, zm), 0,
                                     vol.shape[1] - 1)
                    acc = acc + w[:, None] * vol[slot, zi, yi, xi]
        g3 = torch.where(inside[:, None], acc * P[:, 20:21], 0.0)
        out = torch.where((ttype == TEXTURE_TYPES['grid3d'])[:, None], g3,
                          out)

    if isinstance(attr, torch.Tensor):
        out = torch.where((ttype == TEXTURE_TYPES['mesh_attribute'])[:, None],
                          attr * P[:, 20:21], out)
    return torch.where((tex_id >= 0)[:, None], out, 0.0)

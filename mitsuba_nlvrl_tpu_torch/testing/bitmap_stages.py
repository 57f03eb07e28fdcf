"""The bitmap decoders' native stages and their plain twins.

Each stage that ``native/bitmap_*.cpp`` computes for the decoders of
``utils/`` has a twin of the same arguments, results and failures in
numpy and Python, named ``<stage>_plain`` beside it. The load path calls
the native stages only; the tests and ``scripts/port_bitmap_speed.py``
swap the plain twins in with ``plain()`` to hold one against the other.
``png_filtered`` writes the PNG files that exercise the row filters, and
``picture`` the smooth seeded pictures the large files are made of.
"""
from __future__ import annotations

import contextlib
import importlib
import struct
import zlib

import numpy as np

# (module of utils, stage): each has its twin, stage + '_plain'
STAGES = (('io', '_png_unfilter'), ('jpeg', '_decode_scan'),
          ('jpeg', '_idct_plane'), ('jpeg', '_upsample'),
          ('jpeg', '_ycc_to_rgb'), ('vp8l', '_pixels'),
          ('vp8l', '_unpredict'), ('vp8l', '_uncross'),
          ('vp8', '_macroblocks'), ('vp8', 'yuv_to_rgb'))


def _module(name: str):
    return importlib.import_module(f'{__package__.rsplit(".", 1)[0]}'
                                   f'.utils.{name}')


@contextlib.contextmanager
def plain():
    """Decode through the plain twins while the block runs."""
    saved = []
    try:
        for mod, stage in STAGES:
            m = _module(mod)
            saved.append((m, stage, getattr(m, stage)))
            setattr(m, stage, getattr(m, stage + '_plain'))
        yield
    finally:
        for m, stage, fn in reversed(saved):
            setattr(m, stage, fn)


@contextlib.contextmanager
def forbid_plain():
    """Make every plain twin raise while the block runs: what decodes in
    it took the native path."""
    saved = []

    def refuse(*args, **kwargs):
        raise AssertionError("a plain twin was called on the load path")
    try:
        for mod, stage in STAGES:
            m = _module(mod)
            saved.append((m, stage + '_plain', getattr(m, stage + '_plain')))
            setattr(m, stage + '_plain', refuse)
        yield
    finally:
        for m, name, fn in reversed(saved):
            setattr(m, name, fn)


def png_filtered(img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG file of an (H, W, 3) or (H, W, 4) uint8 image, 8 bits a
    sample, its row y filtered by ``filters[y % len(filters)]`` (0 none, 1
    sub, 2 up, 3 average, 4 Paeth), as libpng writes photographs."""
    H, W, C = img.shape
    # the image with a zero row above and C zero bytes to the left
    xp = np.zeros((H + 1, (W + 1) * C), np.int16)
    xp[1:, C:] = img.reshape(H, W * C)
    x, left, up, ul = xp[1:, C:], xp[1:, :-C], xp[:-1, C:], xp[:-1, :-C]
    ftype = np.asarray(filters, np.uint8)[np.arange(H) % len(filters)]
    rows = np.empty((H, W * C + 1), np.uint8)
    rows[:, 0] = ftype
    for f in np.unique(ftype):
        if f == 4:
            pa, pb = np.abs(up - ul), np.abs(left - ul)
            pc = np.abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0, left, up, (left + up) >> 1)[f]
        res = (x - pred).astype(np.uint8)        # mod 256
        sel = ftype == f
        rows[sel, 1:] = res[sel] if len(filters) > 1 else res

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return struct.pack('>I', len(payload)) + tag + payload + \
            struct.pack('>I', zlib.crc32(tag + payload) & 0xFFFFFFFF)
    ihdr = struct.pack('>IIBBBBB', W, H, 8, {3: 2, 4: 6}[C], 0, 0, 0)
    return b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr) + chunk(
        b'IDAT', zlib.compress(rows.tobytes(), 1)) + chunk(b'IEND', b'')


def picture(n: int, seed: int, noisy: float = 1.0) -> np.ndarray:
    """An n x n RGB uint8 picture as a texture's photograph is: smooth
    colour waves, seeded darker discs, and mild Gaussian noise (sigma 2)
    on the top ``noisy`` share of its rows (a lossless file of noise
    everywhere would be mostly noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = 127.5 + 110 * np.sin(2 * np.pi * np.stack(
        [3 * xx + yy, 2 * yy - xx, 4 * (xx + yy) * (1 + 0.3 * xx)], -1))
    for cy, cx, r in rng.uniform(0, 1, (24, 3)):
        r = 0.02 + 0.06 * r
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] *= 0.6
    rows = int(round(noisy * n))
    img[:rows] += rng.normal(0.0, 2.0, (rows, n, 3))
    return np.clip(img, 0, 255).astype(np.uint8)

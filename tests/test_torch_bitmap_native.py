"""The bitmap decoders' native stages (``native/bitmap_*.cpp``, built with
g++ at first use) against their plain twins, PIL and the reference.

(a) Each native stage equals its plain twin (``<stage>_plain``, numpy and
Python) on the same inputs: PNG unfiltering of seeded rows of every
filter at every pixel size; TIFF's and GIF's LZW of seeded pictures, with
and without a clear at a full table; WebP's alpha gradient filter; lossless
JPEG scans at predictors 1-7; the JPEG coefficient arrays after every scan
of each fixture, then its IDCT, upsampling and colour conversion; WebP
lossless pixels (with the bit position after them), predictor and
cross-colour transforms; the lossy frame's Y, U and V planes and their
RGB. (b) Every fixture decodes to PIL's stored bytes with every plain
twin made to raise. (c) Files at a texture's size (1,024 x 1,024, written
at test time by PIL or, for PNG, by numpy with the five filters cycling
by row) load equal in bits to the reference's ``load_bitmap``. (d) Seeded
truncations and byte flips of fixtures fail with the plain path's
exception type or decode to what it decodes, in a process of their own
(``torch_bitmap_corrupt_worker.py``), so a crash fails one test; so do
seeded cuts and flips of the LZW streams, alpha planes and lossless scans
that the stages of slice 16 take, and of the code-block data and wavelet
coefficients that JPEG 2000's stages take (slice 18: tier 1, the 5/3 and
the 9/7 each equal to its twin on every fixture's calls and on seeded
random inputs, the colour transforms and level shift on seeded planes
with the float path's edges), and of the Zstandard frames, ThunderScan
data and word-aligned CCITT RLE strips of slice 19 (each stage equal to
its twin on seeded inputs: ``zstandard``'s frames, a test-only package,
and the coders of ``testing/bitmap_stages``), and of the Sun raster RLE,
MSP rows, FLI frames and BLP's DXT blocks of slice 20 (each stage equal
to its twin on seeded inputs coded by ``testing/raster_files``). A failed
compile raises with the compiler's message: there is no fallback.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import native, texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages
from mitsuba_nlvrl_tpu_torch.testing import raster_files
from mitsuba_nlvrl_tpu_torch.utils import (ccitt, dds, fli, gif, io as pio,
                                           j2k, jpeg, msp, sun, tiff, vp8,
                                           vp8l, webp, zstd)

torch.set_num_threads(1)   # one intra-op thread a test worker

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
LARGE = os.path.join(HERE, 'data', 'webp_large')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
JPEG_FIXTURES = sorted(n for n in WANT.files if n.endswith('.jpg'))
WEBP_FILES = [os.path.join(FIXTURES, n) for n in sorted(WANT.files)
              if n.endswith('.webp')] + [
    os.path.join(LARGE, n) for n in ('lossless_512.webp', 'lossy_512.webp')]


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert('RGB'))


# --- (a) each native stage against its plain twin -------------------------

@pytest.mark.parametrize('bpp', (1, 2, 3, 4, 6, 8))
def test_png_unfilter_matches_plain(bpp):
    rng = np.random.default_rng(bpp)
    H, stride = 25, 7 * bpp + 3
    raw = b''.join(bytes([y % 5]) + rng.integers(
        0, 256, stride, dtype=np.uint8).tobytes() for y in range(H))
    got = pio._png_unfilter(raw, H, stride, bpp)
    want = pio._png_unfilter_plain(raw, H, stride, bpp)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the plain version's failures: a missing filter byte, a short row, an
    # unknown filter
    for bad in (raw[:stride + 1], raw[:-1], raw[:stride + 1] + b'\x05'
                + raw[stride + 2:]):
        kinds = []
        for fn in (pio._png_unfilter, pio._png_unfilter_plain):
            with pytest.raises((IndexError, ValueError)) as e:
                fn(bad, H, stride, bpp)
            kinds.append((type(e.value), str(e.value)))
        assert kinds[0] == kinds[1]


def _paired(monkeypatch, module, stage, seen):
    """Run ``stage`` of ``module`` and its plain twin on the same inputs
    at every call, assert equal results, and return the native one."""
    native_fn = getattr(module, stage)
    plain_fn = getattr(module, stage + '_plain')

    def both(*args):
        want = plain_fn(*args)
        got = native_fn(*args)
        _equal(got, want)
        seen.append(stage)
        return got
    monkeypatch.setattr(module, stage, both)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (got.astype(np.int64) == want.astype(np.int64)).all()


@pytest.mark.parametrize('name', JPEG_FIXTURES)
def test_jpeg_stages_match_plain(name, monkeypatch):
    """The coefficients after every scan, then the samples of the IDCT,
    the upsampling and the colour conversion."""
    seen = []
    native_scan = jpeg._decode_scan

    def scan_both(scan, comps, sel, tables, restart, mcux, mcuy, spec):
        twin = [dict(c, coef=c['coef'].copy()) for c in comps]
        jpeg._decode_scan_plain(scan, twin, sel, tables, restart, mcux, mcuy,
                                spec)
        native_scan(scan, comps, sel, tables, restart, mcux, mcuy, spec)
        for c, t in zip(comps, twin):
            assert c['coef'].dtype == t['coef'].dtype == np.int16
            assert c['coef'].tobytes() == t['coef'].tobytes(), spec
        seen.append('_decode_scan')
    monkeypatch.setattr(jpeg, '_decode_scan', scan_both)
    for stage in ('_idct_plane', '_upsample', '_ycc_to_rgb'):
        _paired(monkeypatch, jpeg, stage, seen)
    got = ptex._pil_rgb(*jpeg.read_jpeg_mode(os.path.join(FIXTURES, name)))
    assert got.tobytes() == WANT[name].tobytes()
    scans = seen.count('_decode_scan')
    assert scans >= (2 if 'progressive' in name else 1), seen
    assert '_idct_plane' in seen and '_upsample' in seen


@pytest.mark.parametrize('path', WEBP_FILES, ids=os.path.basename)
def test_webp_stages_match_plain(path, monkeypatch):
    """VP8L: the ARGB words of every entropy-coded image and the bit
    position after them, the predictor and cross-colour transforms
    undone; VP8: the filtered Y, U and V planes and their RGB."""
    seen = []
    native_pixels = vp8l._pixels

    def pixels_both(br, w, h, cache_bits, groups, meta):
        start = br.pos, br.val, br.nb
        want = np.asarray(vp8l._pixels_plain(br, w, h, cache_bits, groups,
                                             meta), np.uint32)
        end = br.bitpos
        br.pos, br.val, br.nb = start
        got = native_pixels(br, w, h, cache_bits, groups, meta)
        assert got.tobytes() == want.tobytes() and br.bitpos == end
        seen.append('_pixels')
        return got

    def yuv_both(data):
        w, h, br, *rest = vp8._frame(data)
        mb = ((w + 15) >> 4, (h + 15) >> 4)
        got = vp8._macroblocks(br, rest[0], *mb, *rest[1:])
        _, _, br, *rest = vp8._frame(data)
        want = vp8._macroblocks_plain(br, rest[0], *mb, *rest[1:])
        for g, p in zip(got, want):
            assert g.tobytes() == p.tobytes()
        seen.append('_macroblocks')
        return (w, h) + tuple(got)
    monkeypatch.setattr(vp8l, '_pixels', pixels_both)
    monkeypatch.setattr(vp8, 'decode_yuv', yuv_both)
    for module, stage in ((vp8l, '_unpredict'), (vp8l, '_uncross'),
                          (vp8, 'yuv_to_rgb')):
        _paired(monkeypatch, module, stage, seen)
    mode, px, _ = webp.read_webp(path)
    assert ptex._pil_rgb(mode, px).tobytes() == _pil_rgb(path).tobytes()
    assert seen and set(seen) <= {'_pixels', '_macroblocks', '_unpredict',
                                  '_uncross', 'yuv_to_rgb'}


def _lzw_tiff(data: bytes, clear_when_full: bool = True) -> bytes:
    """TIFF LZW codes of ``data``, packed MSB first, the width following
    the decoder's table as it grows (one code early). With
    ``clear_when_full`` False no clear is sent once 4,096 entries are
    defined: coding goes on at 12 bits while the decoder's table grows."""
    table = {bytes([i]): i for i in range(256)}
    codes, width, nxt, dsize, first = [(256, 9)], 9, 258, 258, True
    cur = b''

    def emit(code):
        nonlocal width, dsize, first
        codes.append((code, width))
        dsize += 0 if first else 1
        first = False
        if dsize >= (1 << width) - 1 and width < 12:
            width += 1
    for v in data:
        s = cur + bytes([v])
        if s in table:
            cur = s
            continue
        emit(table[cur])
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
        if clear_when_full and nxt == 4094:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            width, nxt, dsize, first = 9, 258, 258, True
        cur = bytes([v])
    emit(table[cur])
    codes.append((257, width))
    acc = nacc = 0
    out = bytearray()
    for c, n in codes:
        acc = (acc << n) | c
        nacc += n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


@pytest.mark.parametrize('n,full', [(128, True), (256, True), (128, False)])
def test_tiff_lzw_matches_plain(n, full):
    """Seeded pictures' LZW streams, clearing at a full table or coding on
    past it; the stream cut short of, or longer than, what is asked."""
    data = bitmap_stages.picture(n, n).tobytes()
    src = _lzw_tiff(data, full)
    for expect in (len(data), len(data) - 7, len(data) + 100):
        got = tiff._lzw(src, expect)
        want = tiff._lzw_plain(src, expect)
        assert got == want and got == data[:expect]
    assert tiff._lzw(src[:len(src) // 3], len(data)) == \
        tiff._lzw_plain(src[:len(src) // 3], len(data))


@pytest.mark.parametrize('bits,full', [(8, True), (8, False), (2, True),
                                       (5, False)])
def test_gif_lzw_matches_plain(bits, full):
    from test_torch_bitmap_formats import _lzw_gif
    n = 160
    idx = bitmap_stages.picture(n, bits)[..., 0] >> (8 - bits)
    src = _lzw_gif(idx.reshape(-1), bits, full)
    for npix in (n * n, n * n - 5, n * n + 9):
        got = gif._lzw(src, bits, npix)
        want = gif._lzw_plain(src, bits, npix)
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == idx.astype(np.uint8).tobytes()[:npix]


@pytest.mark.parametrize('comp,options', [(2, 0), (3, 0), (3, 1), (3, 5),
                                          (4, 0)])
def test_ccitt_matches_plain(comp, options, tmp_path):
    """Seeded bilevel pictures (runs from 1 pixel to the row) coded by
    libtiff in each CCITT scheme: every strip through the native stage
    and its plain twin, equal to each other and to the picture, and the
    strips cut short or overlong."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'scripts'))
    from port_make_bitmaps import libtiff_write
    rng = np.random.default_rng(comp * 10 + options)
    w = 300
    bits = np.zeros((48, w, 1), np.uint8)
    for y in range(48):
        edges = np.cumsum(rng.geometric(rng.uniform(0.005, 0.5), 64))
        for a, b in zip(edges[::2], edges[1::2]):
            bits[y, a:b] = 1
    path = str(tmp_path / 'c.tif')
    libtiff_write(path, bits, 0, comp, bits=1, strip=16,
                  tags=((292, options),) if comp == 3 else ())
    data = open(path, 'rb').read()
    tags, _ = tiff._ifd(data)
    rows = np.packbits(bits[..., 0], axis=1)
    for k, (off, n) in enumerate(zip(tags[273], tags[279])):
        src = data[off:off + n]
        got = ccitt.decode(src, comp, w, 16, options)
        assert got == ccitt.decode_plain(src, comp, w, 16, options)
        assert got == rows[16 * k:16 * (k + 1)].tobytes()
        for cut in (src[:n // 2], src + bytes(9)):
            try:
                want = ccitt.decode_plain(cut, comp, w, 16, options)
            except OSError:
                with pytest.raises(OSError):
                    ccitt.decode(cut, comp, w, 16, options)
                continue
            assert ccitt.decode(cut, comp, w, 16, options) == want


def _zstd_inputs(seed: int) -> list:
    """Seeded inputs and ``zstandard``'s frames of them: (data, frame)."""
    import zstandard
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    kinds = [
        bitmap_stages.picture(64, seed).tobytes(),
        b' '.join(words[i] for i in rng.integers(0, 200, 30_000)),
        rng.integers(0, 12, 150_000, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        bytes(rng.integers(0, 5, 120, dtype=np.uint8)) * 2,
        b''.join(b'x' * int(k) + b'abcdefgh' for k in
                 rng.integers(1, 4, 20_000)),
    ]
    out = []
    for k, data in enumerate(kinds):
        level = (-3, 1, 3, 9, 19, 22)[(seed + k) % 6]
        out.append((data, zstandard.ZstdCompressor(
            level=level, write_checksum=bool(k & 1)).compress(data)))
    return out


@pytest.mark.parametrize('seed', range(3))
def test_zstd_matches_plain(seed):
    """Seeded inputs (pictures, text, a few symbols, noise, runs) coded by
    ``zstandard`` at levels -3 to 22: the native decoder and its twin give
    the input, whole and stopped at ``limit``; cut short, both raise."""
    for data, frame in _zstd_inputs(seed):
        assert zstd.decompress(frame) == data
        assert zstd.decompress_plain(frame) == data
        for limit in (0, 1, 70_000):
            assert zstd.decompress(frame, limit, 1) == \
                zstd.decompress_plain(frame, limit, 1)
        for fn in (zstd.decompress, zstd.decompress_plain):
            with pytest.raises(OSError):
                fn(frame[:len(frame) // 2])


@pytest.mark.parametrize('seed', range(4))
def test_thunderscan_matches_plain(seed):
    """Seeded 4-bit pictures coded by ``bitmap_stages.thunderscan`` at odd
    and even widths: both equal the picture; seeded random code bytes:
    both fail alike or give the same rows."""
    rng = np.random.default_rng(seed)
    w = 31 + seed * 17
    img = bitmap_stages.picture(max(w, 40), seed)[:40, :w, 1] >> 4
    img[5:9] = img[5, 0]
    src = bitmap_stages.thunderscan(img, seed)
    packed = np.zeros((40, (w + 1) // 2), np.uint8)
    packed[:, :w // 2] = (img[:, 0:w - 1:2] << 4) | img[:, 1::2][:, :w // 2]
    if w & 1:
        packed[:, -1] = img[:, -1] << 4
    assert tiff._thunderscan(src, w, 40) == packed.tobytes()
    assert tiff._thunderscan_plain(src, w, 40) == packed.tobytes()
    for k in range(20):
        junk = rng.integers(0, 256, int(rng.integers(1, 400)),
                            dtype=np.uint8).tobytes()
        rows = int(rng.integers(1, 6))
        outcome = []
        for fn in (tiff._thunderscan, tiff._thunderscan_plain):
            try:
                outcome.append(fn(junk, w, rows))
            except OSError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], k


@pytest.mark.parametrize('width', [1, 37, 300, 1800, 2600])
@pytest.mark.parametrize('odd', [0, 1])
def test_ccitt_rlew_matches_plain(width, odd):
    """Seeded bilevel rows coded as word-aligned RLE
    (``bitmap_stages.ccitt_rlew``): native and plain give the rows, at an
    even or odd data address; cut short or overlong, both fail alike or
    give the same rows."""
    rng = np.random.default_rng(width + odd)
    bits = np.zeros((24, width), np.uint8)
    for y in range(24):
        edges = np.cumsum(rng.geometric(rng.uniform(0.002, 0.6), 80))
        for a, b in zip(edges[::2], edges[1::2]):
            bits[y, a:b] = 1
    src = bitmap_stages.ccitt_rlew(bits, odd)
    want = np.packbits(bits, axis=1).tobytes()
    assert ccitt.decode(src, 32771, width, 24, odd) == want
    assert ccitt.decode_plain(src, 32771, width, 24, odd) == want
    for cut in (src[:len(src) // 2], src + bytes(9), src[:-3]):
        outcome = []
        for fn in (ccitt.decode, ccitt.decode_plain):
            try:
                outcome.append(fn(cut, 32771, width, 24, odd))
            except OSError as e:
                outcome.append(type(e))
        assert outcome[0] == outcome[1]


@pytest.mark.parametrize('n,signed', [(1, 0), (2, 0), (3, 0), (4, 0),
                                      (5, 0), (5, 1), (6, 0), (6, 1),
                                      (7, 0)])
@pytest.mark.parametrize('w,h', [(1, 1), (5, 3), (37, 23), (64, 64)])
def test_bcn_matches_plain(n, signed, w, h):
    """Seeded random BCn blocks (every bit pattern a block) at sizes that
    are and are not multiples of 4; cut short, both raise OSError."""
    rng = np.random.default_rng(n * 10 + signed + w)
    size = dds._BLOCK_BYTES[n]
    src = rng.integers(0, 256, -(-w // 4) * -(-h // 4) * size,
                       dtype=np.uint8).tobytes()
    assert dds._bcn(src, w, h, n, bool(signed)).tobytes() == \
        dds._bcn_plain(src, w, h, n, bool(signed)).tobytes()
    for fn in (dds._bcn, dds._bcn_plain):
        with pytest.raises(OSError):
            fn(src[:-1], w, h, n, bool(signed))


@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('w,h', [(1, 1), (5, 3), (37, 23), (64, 64)])
def test_bcn_blp_matches_plain(n, w, h):
    """BLP's DXT1, DXT3 and DXT5 colours (5 and 6 bits shifted up, as
    PIL's BLP plugin expands them) on seeded random blocks."""
    rng = np.random.default_rng(n * 100 + w)
    src = rng.integers(0, 256, -(-w // 4) * -(-h // 4) *
                       dds._BLOCK_BYTES[n], dtype=np.uint8).tobytes()
    got = dds._bcn(src, w, h, n, False, '', True)
    assert got.tobytes() == dds._bcn_plain(src, w, h, n, False, '',
                                           True).tobytes()
    assert got.tobytes() != dds._bcn(src, w, h, n, False).tobytes() or \
        w * h == 1


def _both(fns, *args):
    """Each function's result, or its exception's type and message."""
    out = []
    for fn in fns:
        try:
            r = fn(*args)
            out.append(r.tobytes() if isinstance(r, np.ndarray) else r)
        except (OSError, ValueError) as e:
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize('seed', range(4))
def test_sun_rle_matches_plain(seed):
    """Seeded pictures coded by ``raster_files.sun_rle`` (runs across
    rows, lone and repeated 0x80): both give the rows; seeded random data
    and cuts: both fail alike or give the same rows."""
    rng = np.random.default_rng(seed)
    w, h = 17 + 13 * seed, 11 + seed
    img = bitmap_stages.picture(max(w, h), seed)[:h, :w, 1] // 32 * 32
    img[2:4] = 0x80
    src = raster_files.sun_rle(img.tobytes())
    assert sun._sun_rle(src, w, h).tobytes() == img.tobytes()
    assert sun._sun_rle_plain(src, w, h).tobytes() == img.tobytes()
    for k in range(20):
        junk = src[:int(rng.integers(0, len(src)))] if k % 2 else \
            rng.integers(0, 256, int(rng.integers(1, 300)),
                         dtype=np.uint8).tobytes()
        a, b = _both((sun._sun_rle, sun._sun_rle_plain), junk, w, h)
        assert a == b, k


@pytest.mark.parametrize('seed', range(4))
def test_msp_rle_matches_plain(seed):
    """Seeded bilevel pictures coded by ``raster_files.msp_rows`` (some
    rows all white, so empty): both give the packed rows; seeded rows of
    random bytes and random row lengths: both fail alike or give the same
    stream."""
    rng = np.random.default_rng(seed)
    w, h = 40 + 9 * seed, 12 + seed
    bits = (bitmap_stages.picture(w, seed)[:h, :w, 0] > 100).astype(
        np.uint8)
    bits[3] = 1
    rows = raster_files.msp_rows(bits)
    rowmap = np.array([len(r) for r in rows], np.int64)
    nbytes = (w + 7) // 8
    want = np.packbits(bits, axis=1).tobytes()
    for fn in (msp._msp_rle, msp._msp_rle_plain):
        assert fn(b''.join(rows), rowmap, nbytes, h * nbytes).tobytes() == \
            want
    for k in range(20):
        src = rng.integers(0, 256, int(rng.integers(1, 400)),
                           dtype=np.uint8).tobytes()
        rmap = rng.integers(0, 40, h).astype(np.int64)
        a, b = _both((msp._msp_rle, msp._msp_rle_plain), src, rmap,
                     nbytes, h * nbytes)
        assert a == b, k


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('odd', [0, 1])
def test_fli_frame_matches_plain(seed, odd):
    """Seeded frames of BRUN (with and without copies), LC, SS2, COPY
    and BLACK chunks at odd and even widths: both give the picture the
    chunks make; seeded cuts and byte flips of the frame: both fail alike
    or give the same pixels."""
    rng = np.random.default_rng(seed)
    w, h = 30 + 2 * seed + odd, 19
    a = bitmap_stages.picture(w, seed)[:h, :w, 2] // 16
    b, c = a.copy(), a.copy()
    b[3:9, 2:w - 3] = 77
    c[:] = b
    c[12:15, 1:w - 1] = 201
    c[17, w - 1] = 9
    chunks = [raster_files.fli_colour(rng.integers(0, 256, (256, 3))),
              raster_files.fli_brun(a, copies=bool(seed & 1)),
              raster_files.fli_lc(a, b), raster_files.fli_ss2(b, c),
              raster_files.fli_chunk(18, bytes(20))]
    frame = raster_files.fli_frame(chunks)
    for fn in (fli._fli_frame, fli._fli_frame_plain):
        assert fn(frame, w, h).tobytes() == c.tobytes()
    black = raster_files.fli_frame([raster_files.fli_chunk(16, a.tobytes()),
                                    raster_files.fli_chunk(13, b''),
                                    raster_files.fli_chunk(18, bytes(8))])
    for fn in (fli._fli_frame, fli._fli_frame_plain):
        assert fn(black, w, h).tobytes() == bytes(w * h)
    for k in range(30):
        d = bytearray(frame)
        if k % 3 == 0:
            d = d[:int(rng.integers(0, len(d)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        x, y = _both((fli._fli_frame, fli._fli_frame_plain), bytes(d), w, h)
        assert x == y, k


@pytest.mark.parametrize('shape', [(1, 1), (1, 9), (9, 1), (64, 48),
                                   (256, 256)])
def test_alpha_gradient_matches_plain(shape):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    got = webp._unfilter_gradient(a)
    want = webp._unfilter_gradient_plain(a)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert webp._unfilter(a, 3).tobytes() == want.tobytes()
    for fn in (webp._unfilter_gradient, webp._unfilter_gradient_plain):
        with pytest.raises(IndexError):
            fn(a[:0])


@pytest.mark.parametrize('psv,rows,pt,chans', [
    (1, 0, 0, 1), (2, 4, 0, 3), (3, 0, 2, 3), (4, 16, 0, 1), (5, 0, 0, 3),
    (6, 8, 1, 3), (7, 0, 0, 3)])
def test_lossless_jpeg_matches_plain(psv, rows, pt, chans, tmp_path,
                                     monkeypatch):
    """Predictors 1-7, restart intervals of whole rows, point transforms:
    the samples of the native scan decoder equal the plain one's, and the
    file decodes to PIL's bytes."""
    img = bitmap_stages.picture(128, psv)[:96, :, :chans]
    path = str(tmp_path / 'lossless.jpg')
    with open(path, 'wb') as f:
        f.write(bitmap_stages.jpeg_lossless(
            img if chans == 3 else img[..., 0], psv, rows, pt))
    native_fn = jpeg._decode_lossless
    seen = []

    def both(scan, comps, sel, *rest):
        twin = [dict(c) for c in comps]
        jpeg._decode_lossless_plain(scan, twin, sel, *rest)
        native_fn(scan, comps, sel, *rest)
        for c, t in zip(comps, twin):
            assert c['samples'].tobytes() == t['samples'].tobytes()
        seen.append(len(sel))
    monkeypatch.setattr(jpeg, '_decode_lossless', both)
    got = ptex.read_rgb8(path)
    assert seen == [chans]
    assert got.tobytes() == _pil_rgb(path).tobytes()


@pytest.mark.parametrize('name', ['jp2_rgb.jp2', 'jp2_layers_rates.jp2',
                                  'jp2_codeblock_4x4.jp2',
                                  'j2k_style_all.j2k',
                                  'j2k_style_bypass_layers.j2k',
                                  'j2k_style_vcausal.j2k',
                                  'j2k_rgn_irreversible.j2k',
                                  'j2k_tile_parts.j2k'])
def test_j2k_stages_match_plain(name, monkeypatch):
    """Every call of JPEG 2000's four stages while a fixture decodes: tier
    1 (each tile's code-blocks), the inverse 5/3 or 9/7 of each
    tile-component and the colour transform and level shift, each equal
    to its plain twin in every bit."""
    seen = []
    for stage in ('_t1', '_idwt53', '_idwt97', '_finish'):
        _paired(monkeypatch, j2k, stage, seen)
    got = ptex.read_rgb8(os.path.join(FIXTURES, name))
    assert got.tobytes() == WANT[name].tobytes()
    assert '_t1' in seen and '_finish' in seen
    assert '_idwt53' in seen or '_idwt97' in seen


def _random_blocks(rng, n):
    """Seeded code-blocks: each of 1-16 x 1-16 samples, any orientation,
    bit planes and code-block style, two to four segments of random bytes
    (the bypass ones read raw, the rest MQ-decoded)."""
    data, blocks, segs, off = b'', [], [], 0
    for _ in range(n):
        w, h = (int(v) for v in rng.integers(1, 17, 2))
        nseg = int(rng.integers(1, 5))
        blocks.append((w, h, int(rng.integers(0, 4)),
                       int(rng.integers(0, 13)), int(rng.integers(0, 64)),
                       len(segs), nseg, off))
        for _ in range(nseg):
            chunk = rng.integers(0, 256, int(rng.integers(0, 40)),
                                 dtype=np.uint8).tobytes()
            segs.append((len(data), len(data) + len(chunk),
                         int(rng.integers(1, 12))))
            data += chunk
        off += w * h
    return data, np.asarray(blocks, np.int64), np.asarray(segs, np.int64)


@pytest.mark.parametrize('seed', range(6))
def test_j2k_t1_matches_plain_on_random_blocks(seed):
    """Tier 1 of seeded random code-blocks (every style, orientation and
    bit-plane count, bytes of no encoder) equals its twin; a descriptor
    past its segments or data fails with ValueError, 31 bit planes with
    OSError, in both."""
    rng = np.random.default_rng(seed)
    data, blocks, segs = _random_blocks(rng, 12)
    got = j2k._t1(data, blocks, segs)
    want = j2k._t1_plain(data, blocks, segs)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    bad_seg, bad_planes = blocks.copy(), blocks.copy()
    bad_seg[0, 6] = len(segs) + 1
    bad_planes[0, 3] = 31
    for bad, exc in ((bad_seg, ValueError), (bad_planes, OSError)):
        for fn in (j2k._t1, j2k._t1_plain):
            with pytest.raises(exc):
                fn(data, bad, segs)
    for fn in (j2k._t1, j2k._t1_plain):
        with pytest.raises(ValueError):
            fn(data[:-1] if data else b'', blocks, segs + (len(data) > 0))


def _random_geometry(rng):
    """A tile-component's resolutions (x0, y0, x1, y1), each level
    halving its origin, at a seeded odd or even origin and size (widths
    and heights of 1 among them)."""
    levels = int(rng.integers(1, 6))
    x0, y0 = (int(v) for v in rng.integers(0, 9, 2))
    w, h = (int(v) for v in rng.integers(1, 70, 2))
    geom = []
    for k in range(levels):
        s = levels - 1 - k
        geom.append((-(-x0 >> s), -(-y0 >> s), -(-(x0 + w) >> s),
                     -(-(y0 + h) >> s)))
    return geom, h, w


@pytest.mark.parametrize('seed', range(10))
def test_j2k_wavelets_match_plain(seed):
    """The inverse 5/3 (int32) and 9/7 (float32, no fused multiply-add)
    of seeded coefficients at seeded geometries equal their twins in every
    bit; a geometry larger than the plane fails with ValueError in
    both."""
    rng = np.random.default_rng(seed)
    geom, h, w = _random_geometry(rng)
    ints = rng.integers(-3000, 3000, (h, w)).astype(np.int32)
    floats = (rng.standard_normal((h, w)) * 200).astype(np.float32)
    for fn, plane in ((j2k._idwt53, ints), (j2k._idwt97, floats)):
        got = fn(plane, geom)
        want = getattr(j2k, fn.__name__ + '_plain')(plane, geom)
        assert got.dtype == want.dtype == plane.dtype
        assert got.tobytes() == want.tobytes(), fn.__name__
        for f in (fn, getattr(j2k, fn.__name__ + '_plain')):
            with pytest.raises(ValueError):
                f(plane[:h - 1], [(0, 0, w, h)] * 2)


@pytest.mark.parametrize('reversible', [True, False])
@pytest.mark.parametrize('mct', [True, False])
def test_j2k_finish_matches_plain(reversible, mct):
    """The inverse RCT or ICT and each component's level shift, rounding
    half to even and clamp on seeded planes, the float path's edges among
    them (halves, 2^31, past +-2^31, infinities, NaN), equal their twin;
    planes of other shapes fail with ValueError in both."""
    rng = np.random.default_rng(int(reversible) * 2 + int(mct))
    if reversible:
        planes = [rng.integers(-600, 600, (9, 13)).astype(np.int32)
                  for _ in range(4)]
    else:
        planes = [(rng.standard_normal((9, 13)) * 300).astype(np.float32)
                  for _ in range(4)]
        edges = np.array([0.5, 1.5, -0.5, -2.5, 2.0 ** 31, 2.0 ** 32,
                          -2.0 ** 32, np.inf, -np.inf, np.nan, 127.5,
                          -128.5, 4.5], np.float32)
        planes[0].reshape(-1)[:13] = edges
        planes[3].reshape(-1)[13:26] = edges
    ranges = [(128, 0, 255), (0, -128, 127), (2048, 0, 4095), (1, 0, 1)]
    got = j2k._finish(planes, mct, ranges)
    want = j2k._finish_plain(planes, mct, ranges)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.tobytes() == w.tobytes()
    for fn in (j2k._finish, j2k._finish_plain):
        with pytest.raises(ValueError):
            fn(planes[:2] + [planes[2][:4]], True, ranges[:3])


# --- (b) every fixture, native stages only --------------------------------

@pytest.mark.parametrize('name', WANT.files)
def test_fixture_decodes_to_pil_bytes_natively(name):
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(os.path.join(FIXTURES, name))
    assert got.dtype == np.uint8 and got.tobytes() == WANT[name].tobytes()


def _digests(folder):
    with open(os.path.join(HERE, 'data', folder, 'pil_rgb_sha256.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('folder,name', [
    (folder, name) for folder in ('webp_large', 'bitmaps_large')
    for name in sorted(_digests(folder))])
def test_large_file_decodes_to_pil_digest(folder, name, tmp_path):
    """The files at textures' sizes that ``chip_smoke.py`` decodes on the
    card's host (512^2 to 4,096^2; the seeded random-block DDS files are
    written here)."""
    want = _digests(folder)[name]
    path = bitmap_stages.large_file(os.path.join(HERE, 'data', folder),
                                    name, want, str(tmp_path))
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(path)
    assert list(got.shape) == want['shape']
    assert hashlib.sha256(got.tobytes()).hexdigest() == want['sha256']


# --- (c) a texture's size, against the reference --------------------------

# case -> (PIL format or None for numpy's PNG, save arguments, alpha,
# noisy share of the picture's rows)
SIZE_CASES = {
    'jpeg_baseline_420': ('JPEG', {'quality': 90, 'subsampling': 2}, 0, 1),
    'jpeg_baseline_444': ('JPEG', {'quality': 90, 'subsampling': 0}, 0, 1),
    'jpeg_progressive_420': ('JPEG', {'quality': 90, 'subsampling': 2,
                                      'progressive': True}, 0, 1),
    'jpeg_progressive_444': ('JPEG', {'quality': 90, 'subsampling': 0,
                                      'progressive': True}, 0, 1),
    'webp_lossy': ('WEBP', {'quality': 80}, 0, 1),
    'webp_lossy_alph': ('WEBP', {'quality': 80}, 1, 1),
    'webp_lossless': ('WEBP', {'lossless': True}, 0, 1 / 32),
    'png_five_filters': (None, {}, 0, 1),
    'tiff_lzw_pred2': ('TIFF', {'compression': 'tiff_lzw',
                                'tiffinfo': {317: 2}}, 0, 1),
    'gif_adaptive': ('GIF', {}, 0, 1),
    'tiff_jpeg': ('TIFF', {'compression': 'jpeg', 'quality': 90}, 0, 1),
}


@pytest.mark.parametrize('case', SIZE_CASES)
def test_texture_size_matches_reference(case, tmp_path):
    fmt, kw, alpha, noisy = SIZE_CASES[case]
    img = bitmap_stages.picture(1024, list(SIZE_CASES).index(case), noisy)
    if alpha:
        yy, xx = np.mgrid[0:1024, 0:1024]
        img = np.concatenate([img, ((xx ^ yy) & 255).astype(np.uint8)[
            ..., None]], -1)
    path = str(tmp_path / case)
    if fmt is None:
        with open(path, 'wb') as f:
            f.write(bitmap_stages.png_filtered(img))
    else:
        Image.fromarray(img).save(path, fmt, **kw)
    with bitmap_stages.forbid_plain():
        got = ptex.load_bitmap(path)
        mode, px, _ = ptex._decode(path)
    want = jtex.load_bitmap(path)
    assert got.dtype == want.dtype and got.shape == want.shape == (1024,
                                                                   1024, 3)
    assert got.tobytes() == want.tobytes()
    if alpha:
        assert mode == 'RGBA' and \
            px.tobytes() == np.asarray(Image.open(path)).tobytes()


# --- (d) corrupt input, in a process of its own ---------------------------

def _corrupt_cases(group, tmp_path):
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, 'torch_bitmap_corrupt_worker.py'),
         group, str(tmp_path)], capture_output=True, text=True, timeout=120,
        env=env)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    return json.loads(res.stdout)


@pytest.mark.parametrize('group', ('png', 'jpeg', 'webp_lossless',
                                   'webp_lossy'))
def test_corrupt_input_fails_as_the_plain_path(group, tmp_path):
    cases = _corrupt_cases(group, tmp_path)
    assert len(cases) == 40
    assert [c for c in cases if c[1] != c[2]] == []
    # the cases reach the decoders: some fail, some decode
    assert any(len(c[2]) == 64 for c in cases)
    assert any(len(c[2]) < 64 for c in cases)


@pytest.mark.parametrize('group', ('tiff_lzw', 'gif_lzw', 'alpha_gradient',
                                   'jpeg_lossless', 'ccitt', 'bcn', 'qoi',
                                   'sgi_rle', 'pcx_rle', 'j2k_t1',
                                   'j2k_idwt53', 'j2k_idwt97', 'zstd',
                                   'thunderscan', 'ccitt_rlew', 'sun_rle',
                                   'msp_rle', 'fli_frame', 'bcn_blp'))
def test_corrupt_stage_input_fails_as_the_plain_path(group, tmp_path):
    """An LZW stream, an alpha plane, a lossless scan, a CCITT strip
    (word-aligned RLE among them), BCn blocks (BLP's among them), QOI,
    SGI, PCX, Sun or MSP RLE data, an FLI frame, JPEG 2000 code-block
    data, a tile-component's wavelet coefficients, a Zstandard frame or
    ThunderScan data cut short or with bytes flipped:
    the native stage raises the plain twin's exception type or returns
    its bytes."""
    cases = _corrupt_cases(group, tmp_path)
    assert len(cases) == 40
    assert [c for c in cases if c[1] != c[2]] == []
    assert any(len(c[2]) == 64 for c in cases)


# --- no fallback ----------------------------------------------------------

def test_bitmap_library_raises_with_the_compilers_message(monkeypatch,
                                                          tmp_path):
    fake = tmp_path / 'fake-cxx'
    fake.write_text('#!/bin/sh\necho "fake-cxx: cannot compile" >&2\n'
                    'exit 3\n')
    fake.chmod(0o755)
    monkeypatch.setenv('CXX', str(fake))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_bitmap', None)
    path = str(tmp_path / 'p.png')
    with open(path, 'wb') as f:
        f.write(bitmap_stages.png_filtered(bitmap_stages.picture(8, 0)))
    with pytest.raises(RuntimeError, match='fake-cxx: cannot compile'):
        ptex.read_rgb8(path)
    with pytest.raises(RuntimeError, match='bitmap decoders'):
        ptex.read_rgb8(os.path.join(FIXTURES, 'jpeg_420.jpg'))


def test_lzw_tiff_of_jpeg_pixels_renders_as_the_jpeg(tmp_path):
    """``bitmap_stages.tiff_lzw`` writes a JPEG's pixels as an LZW TIFF
    that PIL and the port read back exactly, and ``cbox_textured`` (16x16,
    1 spp, on the CPU) renders the same image in every bit from either
    (the card's ``textured_large`` phase at a smaller size)."""
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_textured
    jpg = os.path.join(HERE, 'data', 'bitmaps_large', 'jpeg_baseline_512.jpg')
    pixels = ptex.read_rgb8(jpg)
    tif = str(tmp_path / 'lzw.tif')
    with open(tif, 'wb') as f:
        f.write(bitmap_stages.tiff_lzw(pixels, rows=48))
    with bitmap_stages.forbid_plain():
        assert ptex.read_rgb8(tif).tobytes() == pixels.tobytes()
    assert _pil_rgb(tif).tobytes() == pixels.tobytes()
    imgs = []
    for name, bitmap in (('jpeg', jpg), ('tiff', tif)):
        path = cbox_textured(str(tmp_path / name), spp=1, res=16,
                             bitmap=bitmap)
        scene, meta = P.build_scene(load_file(path), device='cpu')
        assert scene.textures.data.shape[1:3] == (512, 512)
        imgs.append(P.render(scene, meta, seed=0))
    assert torch.equal(imgs[0], imgs[1])

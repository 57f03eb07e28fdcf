"""A WebP reader without PIL: the image, or an animation's first frame,
as PIL's ``Image.open`` gives it (the bitstreams' decoders run their
sequential stages in host C++, see ``vp8.py`` and ``vp8l.py``).

PIL opens every WebP through libwebp's animation decoder: the container
is checked as libwebp's demuxer checks it, the first frame is decoded
into a canvas cleared to transparent black, and the mode is ``RGBA``
where libwebp reports alpha (``WebPGetFeatures``), else ``RGB``. Read
here:

  * simple files: one ``VP8 `` (lossy, ``utils/vp8.py``) or ``VP8L``
    (lossless, ``utils/vp8l.py``) chunk;
  * extended files: ``VP8X`` (the canvas and its flags); ``ALPH`` before
    a lossy bitstream, raw (method 0) or a VP8L stream of the image's
    size in its green bytes (method 1), unfiltered by none, horizontal,
    vertical or gradient prediction; ``ICCP``, ``EXIF``, ``XMP `` and
    unknown chunks are skipped, as PIL applies no profile at open;
  * animations: ``ANIM`` and the first ``ANMF``, its frame (``ALPH`` and
    ``VP8 ``, or ``VP8L``) decoded at its offset into the canvas.

RGB and alpha are not premultiplied, as libwebp hands them to PIL. A
truncated or malformed file raises ``OSError`` and no partial image is
returned (PIL refuses a truncated file at open; a bitstream that fails
to decode PIL reports at load).
"""
from __future__ import annotations

import numpy as np

from . import vp8, vp8l

_ALPHA, _ANIMATION = 0x10, 0x02
_VALID_FLAGS = 0x3E              # alpha, animation, ICC, EXIF and XMP


def _chunks(data: bytes, start: int, end: int):
    """(tag, payload) of each chunk in data[start:end]; a chunk that runs
    past the end is a truncated file."""
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos + 4:pos + 8], 'little')
        if pos + 8 + size > end:
            raise OSError("truncated WebP chunk")
        yield data[pos:pos + 4], data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    if pos < end:
        raise OSError("truncated WebP chunk header")


def _frame(chunks) -> tuple:
    """A frame's (ALPH payload or None, image tag, image payload) from its
    chunks: an optional ``ALPH`` then ``VP8 `` or ``VP8L``."""
    alph = None
    for tag, payload in chunks:
        if tag == b'ALPH':
            if alph is None:
                alph = payload
        elif tag in (b'VP8 ', b'VP8L'):
            if tag == b'VP8L' and alph is not None:
                raise OSError("WebP ALPH before a lossless bitstream")
            return alph, tag, payload
    raise OSError("WebP frame without an image bitstream")


def _size(tag: bytes, payload: bytes) -> tuple:
    """(width, height, alpha) a bitstream's header declares."""
    if tag == b'VP8L':
        return vp8l.header(payload)
    if len(payload) < 10:
        raise OSError("truncated VP8 frame header")
    w = (payload[6] | payload[7] << 8) & 0x3FFF
    h = (payload[8] | payload[9] << 8) & 0x3FFF
    return w, h, 0


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """Undo an alpha plane's prediction: 1 horizontal, 2 vertical, 3
    gradient (``_unfilter_gradient``)."""
    if method == 0:
        return a
    if method == 3:
        return _unfilter_gradient(a)
    a = a.astype(np.int64)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 255
    for y in range(1, a.shape[0]):
        if method == 1:
            out[y] = (np.cumsum(a[y]) + out[y - 1, 0]) & 255
        else:
            out[y] = (a[y] + out[y - 1]) & 255
    return out.astype(np.uint8)


def _unfilter_gradient(a: np.ndarray) -> np.ndarray:
    """Undo an alpha plane's gradient filter (the top row predicted from
    the left, the left column from above, the first pixel from 0), in
    ``native/bitmap_vp8l.cpp``. Fails as ``_unfilter_gradient_plain``
    does."""
    from ..native import bitmap_library, ptr
    a = np.ascontiguousarray(a, np.uint8)
    h, w = a.shape
    if h == 0:
        raise IndexError("index 0 is out of bounds for axis 0 with size 0")
    out = np.empty_like(a)
    bitmap_library().mnt_alpha_ungradient(ptr(a), h, w, ptr(out))
    return out


def _unfilter_gradient_plain(a: np.ndarray) -> np.ndarray:
    """``_unfilter_gradient`` in numpy and Python, the plain version the
    tests hold it to (each row walked pixel by pixel)."""
    a = a.astype(np.int64)
    h, w = a.shape
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 255
    for y in range(1, h):
        top, row, d = out[y - 1].tolist(), a[y].tolist(), [0] * w
        left = tl = top[0]
        for x in range(w):
            t = top[x]
            g = left + t - tl
            left = (row[x] + (0 if g < 0 else 255 if g > 255 else g)) & 255
            tl = t
            d[x] = left
        out[y] = d
    return out.astype(np.uint8)


def _alpha(payload: bytes, w: int, h: int) -> np.ndarray:
    """The (h, w) alpha plane of an ``ALPH`` chunk."""
    if not payload:
        raise OSError("empty WebP ALPH chunk")
    head = payload[0]
    method, filt, pre = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or pre > 1 or head >> 6:
        raise OSError("bad WebP ALPH header")
    if method == 0:
        if len(payload) - 1 < w * h:
            raise OSError("truncated WebP alpha plane")
        a = np.frombuffer(payload, np.uint8, w * h, 1).reshape(h, w)
    else:
        a = vp8l.decode_alpha(payload[1:], w, h)
    return _unfilter(a, filt)


def _rgba(alph, tag: bytes, payload: bytes) -> np.ndarray:
    """A frame's (H, W, 4) RGBA bytes."""
    if tag == b'VP8L':
        argb = vp8l.decode(payload)         # bytes B, G, R, A in memory
        bgra = np.ascontiguousarray(argb, '<u4').view(np.uint8).reshape(
            argb.shape + (4,))
        return bgra[..., [2, 1, 0, 3]]
    rgb = vp8.decode(payload)
    h, w = rgb.shape[:2]
    a = np.full((h, w, 1), 255, np.uint8) if alph is None else \
        _alpha(alph, w, h)[..., None]
    return np.concatenate([rgb, a], -1)


def decode_webp(data: bytes):
    """(mode, pixels, None) of a WebP file's bytes as PIL opens it:
    ``RGBA`` (H, W, 4) or ``RGB`` (H, W, 3) uint8."""
    if len(data) < 12 or data[:4] != b'RIFF' or data[8:12] != b'WEBP':
        raise OSError("not a WebP file")
    riff = int.from_bytes(data[4:8], 'little')
    if riff < 12:
        raise OSError("WebP RIFF size too small")
    if riff + 8 > len(data):
        raise OSError("truncated WebP file")
    end = riff + 8
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise OSError("WebP file without chunks")
    tag, payload = chunks[0]
    if tag in (b'VP8 ', b'VP8L'):                      # a simple file
        return _mode(_rgba(None, tag, payload),
                     bool(_size(tag, payload)[2]))
    if tag != b'VP8X':
        raise OSError(f"WebP file starting with chunk {tag!r}")
    if len(payload) < 10:
        raise OSError("truncated WebP VP8X chunk")
    flags = payload[0]
    cw = 1 + int.from_bytes(payload[4:7], 'little')
    ch = 1 + int.from_bytes(payload[7:10], 'little')
    if flags & ~_VALID_FLAGS & 0xFF:
        raise OSError("WebP VP8X with unknown flags")
    rest = chunks[1:]
    if any(t == b'VP8X' for t, _ in rest):
        raise OSError("WebP file with two VP8X chunks")
    if flags & _ANIMATION:
        tags = [t for t, _ in rest]
        if b'ANMF' not in tags or b'ANIM' not in tags or \
                tags.index(b'ANIM') > tags.index(b'ANMF'):
            raise OSError("WebP animation without ANIM then ANMF")
        if any(t in (b'ALPH', b'VP8 ', b'VP8L') for t in
               tags[:tags.index(b'ANMF')]):
            raise OSError("WebP animation with a bitstream outside ANMF")
        frame = rest[tags.index(b'ANMF')][1]
        if len(frame) < 16:
            raise OSError("truncated WebP ANMF chunk")
        x0 = 2 * int.from_bytes(frame[0:3], 'little')
        y0 = 2 * int.from_bytes(frame[3:6], 'little')
        alph, tag, payload = _frame(_chunks(frame, 16, len(frame)))
        fw, fh, _ = _size(tag, payload)
        if x0 + fw > cw or y0 + fh > ch:
            raise OSError("WebP frame outside the canvas")
        canvas = np.zeros((ch, cw, 4), np.uint8)     # transparent black
        canvas[y0:y0 + fh, x0:x0 + fw] = _rgba(alph, tag, payload)
        return _mode(canvas, bool(flags & _ALPHA))
    alph, tag, payload = _frame(rest)
    fw, fh, lossless_alpha = _size(tag, payload)
    if (fw, fh) != (cw, ch):
        raise OSError("WebP image size differs from its canvas")
    # libwebp: a lossless bitstream's own alpha hint stands in for the
    # VP8X flag; an ALPH chunk means alpha either way
    has_alpha = lossless_alpha if tag == b'VP8L' else flags & _ALPHA
    return _mode(_rgba(alph, tag, payload),
                 bool(has_alpha) or alph is not None)


def _mode(rgba: np.ndarray, has_alpha: bool):
    if has_alpha:
        return 'RGBA', rgba, None
    return 'RGB', np.ascontiguousarray(rgba[..., :3]), None


def read_webp(path: str):
    """(mode, pixels, None) of a WebP file as PIL's ``Image.open`` gives
    it (its first frame if animated)."""
    with open(path, 'rb') as f:
        return decode_webp(f.read())

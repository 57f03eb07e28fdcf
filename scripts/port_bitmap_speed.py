"""Bitmap decode time at textures' sizes: the port's native decoders, their
plain twins and PIL, on one host.

    python3 scripts/port_bitmap_speed.py [--reps 3] [--no-plain]

Decodes every file of ``tests/data/webp_large`` (WebP at 512 x 512) and
``tests/data/bitmaps_large`` (JPEG at 512 x 512, JPEG and WebP at 2,048 x
2,048 and 4,096 x 4,096) and three PNG files written here by numpy with
every row Paeth-filtered (512, 2,048 and 4,096 square; their pixels are
known) through ``texture.read_rgb8``: the native stages (median of
``--reps``), the plain stages (``testing/bitmap_stages.plain``, once, the
2,048 x 2,048 files only) and PIL's ``Image.open(f).convert('RGB')``
(median of ``--reps``). Plain and PIL are skipped on a host without
PIL. Every decode is checked against PIL's digest or the known pixels.
Prints the host's CPU model and count, then one JSON line a file:
milliseconds and milliseconds per megapixel of each, and plain over
native.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from mitsuba_nlvrl_tpu_torch import native, texture  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages  # noqa: E402

try:
    from PIL import Image
except ImportError:           # a host without PIL: native timings only
    Image = None

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tests', 'data')


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, reps: int):
    """(median milliseconds, last result) of ``reps`` calls."""
    ms, out = [], None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms), out


def files(workdir: str) -> list:
    """(path, check) of each file: check(rgb) holds when the decode is
    PIL's."""
    out = []
    for folder in ('webp_large', 'bitmaps_large'):
        with open(os.path.join(DATA, folder, 'pil_rgb_sha256.json')) as f:
            digests = json.load(f)
        for name, d in sorted(digests.items()):
            out.append((os.path.join(DATA, folder, name), lambda rgb, d=d: (
                hashlib.sha256(rgb.tobytes()).hexdigest() == d['sha256'])))
    for n in (512, 2048, 4096):
        img = bitmap_stages.picture(n, n)
        path = os.path.join(workdir, f'png_paeth_{n}.png')
        with open(path, 'wb') as f:
            f.write(bitmap_stages.png_filtered(img, filters=(4,)))
        out.append((path, lambda rgb, img=img: np.array_equal(rgb, img)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--no-plain', action='store_true',
                    help="skip the plain stages (minutes at 2,048^2)")
    args = ap.parse_args()
    emit({'host_cpu': native._cpu_model(), 'cpus': os.cpu_count(),
          'pil': Image is not None,
          'library': native.build(native.BITMAP_SOURCES, 'bitmap',
                                  'the bitmap decoders')})
    texture.read_rgb8(os.path.join(DATA, 'bitmaps', 'picture64.png'))
    with tempfile.TemporaryDirectory() as workdir:
        for path, check in files(workdir):
            ms, rgb = timed(lambda: texture.read_rgb8(path), args.reps)
            if not check(rgb):
                raise SystemExit(f"{path}: the native decode is not PIL's")
            mpix = rgb.shape[0] * rgb.shape[1] / 1e6
            rec = {'file': os.path.basename(path), 'mpix': mpix,
                   'native_ms': ms, 'native_ms_per_mpix': ms / mpix}
            if Image is not None:
                pil_ms, ref = timed(lambda: np.asarray(
                    Image.open(path).convert('RGB')), args.reps)
                if not check(ref):
                    raise SystemExit(f"{path}: PIL's decode differs")
                rec.update(pil_ms=pil_ms, pil_ms_per_mpix=pil_ms / mpix,
                           native_over_pil=ms / pil_ms)
                if not args.no_plain and rgb.shape[0] <= 2048:
                    with bitmap_stages.plain():
                        plain_ms, out = timed(
                            lambda: texture.read_rgb8(path), 1)
                    if not check(out):
                        raise SystemExit(f"{path}: the plain decode differs")
                    rec.update(plain_ms=plain_ms,
                               plain_ms_per_mpix=plain_ms / mpix,
                               plain_over_native=plain_ms / ms)
            emit(rec)


if __name__ == '__main__':
    main()

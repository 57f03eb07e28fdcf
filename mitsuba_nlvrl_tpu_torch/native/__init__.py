"""Native (C++) host code, built with ``g++`` at first use and loaded with
``ctypes``.

Two libraries, each built by ``build`` from its sources:

  * the BVH builder (``bvh_native.cpp``), the port of
    ``mitsuba_nlvrl_tpu/native/__init__.py`` (the reference's own source,
    copied);
  * the bitmap decoders' sequential stages (``bitmap_png.cpp``,
    ``bitmap_jpeg.cpp``, ``bitmap_vp8l.cpp``, ``bitmap_vp8.cpp``,
    ``bitmap_lzw.cpp``, ``bitmap_ccitt.cpp``, ``bitmap_bcn.cpp``,
    ``bitmap_raster.cpp``, ``bitmap_j2k.cpp``): PNG unfiltering, JPEG
    entropy decoding, IDCT
    and lossless scans, WebP's lossless pixels and predictor, its alpha
    plane's gradient filter, the lossy frame's modes, tokens,
    reconstruction and loop filter, TIFF's and GIF's LZW, TIFF's CCITT
    coding, DDS's (and BLP's) BCn blocks, QOI's ops, SGI's, PCX's, Sun
    raster's and MSP's RLE and FLI/FLC's frame chunks, and JPEG 2000's
    tier 1, inverse wavelets and colour transforms. ``utils/io.py``,
    ``jpeg.py``, ``vp8l.py``, ``vp8.py``, ``webp.py``, ``tiff.py``,
    ``gif.py``, ``ccitt.py``, ``dds.py``, ``qoi.py``, ``sgi.py``,
    ``pcx.py``, ``sun.py``, ``msp.py``, ``fli.py`` and ``j2k.py`` bind
    them (``bitmap_library``).

Each is compiled with the reference's flags into
``mitsuba_nlvrl_tpu_torch/_build/`` under a name that carries a hash of its
sources, the flags and the CPU model. Unlike the reference there is no
numpy fallback: a scene's triangle order and its bitmaps' pixels must not
depend on whether a compiler happened to be found, so a failed compile
raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
# the reference's flags (mitsuba_nlvrl_tpu/native/__init__.py)
CXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC', '-march=native']
BVH_SOURCES = ('bvh_native.cpp',)
BITMAP_SOURCES = ('bitmap_png.cpp', 'bitmap_jpeg.cpp', 'bitmap_vp8l.cpp',
                  'bitmap_vp8.cpp', 'bitmap_lzw.cpp', 'bitmap_ccitt.cpp',
                  'bitmap_bcn.cpp', 'bitmap_raster.cpp', 'bitmap_j2k.cpp',
                  'bitmap_zstd.cpp')

_lock = threading.Lock()
_fn = None
_bitmap = None


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code is built for it,
    so a checkout shared between hosts keeps one library per CPU."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def library_path(sources=BVH_SOURCES, stem: str = 'bvh') -> str:
    """Where the library ``libmnt_<stem>_<hash>.so`` of ``sources`` (file
    names in this directory) is built."""
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(_DIR, name), 'rb') as f:
            h.update(f.read())
    h.update(' '.join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f'libmnt_{stem}_{h.hexdigest()[:16]}.so')


def build(sources=BVH_SOURCES, stem: str = 'bvh',
          what: str = 'the BVH builder') -> str:
    """Compile ``sources`` (``what``, for the error) into one library if
    it is missing; returns its path. One compiler a source, started
    together, then one link. Concurrent first builds (test workers) each
    write files of their own and rename the library into place. Raises
    RuntimeError carrying the compiler's message on failure."""
    path = library_path(sources, stem)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f'{os.getpid()}.{threading.get_ident()}'
    tmp = f'{path}.{tag}.tmp'
    cxx = os.environ.get('CXX', 'g++')
    objs = [f'{path}.{i}.{tag}.o' for i in range(len(sources))]
    compile_flags = [f for f in CXX_FLAGS if f != '-shared']
    steps = [[[cxx, *compile_flags, '-c', os.path.join(_DIR, s), '-o', o]
              for s, o in zip(sources, objs)],
             [[cxx, *CXX_FLAGS, *objs, '-o', tmp]]]
    try:
        for cmds in steps:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for c in cmds]
            for cmd, proc in zip(cmds, procs):
                try:
                    _, err = proc.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    for p in procs:
                        p.kill()
                        p.communicate()
                    raise
                if proc.returncode != 0:
                    for p in procs:
                        p.communicate()
                    raise RuntimeError(
                        f"building {what} failed ({proc.returncode}): "
                        f"{' '.join(cmd)}\n{err}")
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {what} failed: {e}") from e
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)
    return path


_P = ctypes.c_void_p
_I64, _I32 = ctypes.c_int64, ctypes.c_int
# each function's argtypes, as the sources declare them (restype int but
# for the void functions of _BITMAP_VOID and the counts of _BITMAP_COUNT)
_BITMAP_ABI = {
    'mnt_png_unfilter': [_P, _I64, _I64, _I64, _I64, _P, _P],
    'mnt_jpeg_scan': [_P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                      _I32, _I32, _I32, _I32, _P],
    'mnt_jpeg_idct': [_P, _I64, _I64, _P, _P],
    'mnt_jpeg_upsample': [_P, _I64, _I64, _I32, _I32, _I64, _I64, _P],
    'mnt_jpeg_ycc_rgb': [_P, _P, _P, _I64, _P],
    'mnt_vp8l_pixels': [_P, _I64, _P, _I64, _I64, _I32, _P, _P, _P, _I64,
                        _I32, _I64, _P, _I64, _P],
    'mnt_vp8l_unpredict': [_P, _I64, _I64, _I32, _P, _I64, _P],
    'mnt_vp8l_uncross': [_P, _I64, _I64, _I32, _P, _I64, _P],
    'mnt_vp8_frame': [_P, _I64, _P, _P, _P, _I32, _I64, _I64, _I32, _P,
                      _I32, _P, _P, _P, _I32, _P, _P, _P, _P],
    'mnt_vp8_yuv_rgb': [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    'mnt_jpeg_lossless': [_P, _I64, _I32, _P, _P, _I64, _I64, _I64, _I32,
                          _I32, _P, _P],
    'mnt_alpha_ungradient': [_P, _I64, _I64, _P],
    'mnt_tiff_lzw': [_P, _I64, _P, _I64],
    'mnt_gif_lzw': [_P, _I64, _I32, _P, _I64],
    'mnt_ccitt_decode': [_P, _I64, _I32, _I64, _I64, _I32, _I32, _P],
    'mnt_bcn_decode': [_P, _I64, _I64, _I64, _I32, _I32, _P],
    'mnt_qoi_decode': [_P, _I64, _I64, _I32, _P],
    'mnt_sgi_rle_rows': [_P, _I64, _P, _P, _I64, _I64, _I32, _P],
    'mnt_pcx_rle': [_P, _I64, _I64, _I64, _P, _P],
    'mnt_thunderscan': [_P, _I64, _I64, _I64, _P],
    'mnt_j2k_t1': [_P, _P, _I64, _P, _P],
    'mnt_j2k_idwt53': [_P, _I64, _P, _I64],
    'mnt_j2k_idwt97': [_P, _I64, _P, _I64],
    'mnt_j2k_mct': [_P, _P, _P, _I64, _I32],
    'mnt_j2k_level': [_P, _I64, _I32, _I64, _I64, _I64, _P],
    'mnt_zstd_decompress': [_P, _I64, _P, _I64, _I64, _I64],
    'mnt_sun_rle': [_P, _I64, _I64, _I64, _P],
    'mnt_msp_rle': [_P, _I64, _P, _I64, _I64, _P, _I64],
    'mnt_fli_frame': [_P, _I64, _I64, _I64, _P],
}
# functions that return a count (int64) rather than an error code
_BITMAP_COUNT = ('mnt_tiff_lzw', 'mnt_gif_lzw', 'mnt_zstd_decompress',
                 'mnt_msp_rle')

_BITMAP_VOID = ('mnt_jpeg_idct', 'mnt_jpeg_upsample', 'mnt_jpeg_ycc_rgb',
                'mnt_vp8l_unpredict', 'mnt_vp8l_uncross', 'mnt_vp8_yuv_rgb',
                'mnt_alpha_ungradient', 'mnt_j2k_idwt53', 'mnt_j2k_idwt97',
                'mnt_j2k_mct', 'mnt_j2k_level')


def bitmap_library() -> ctypes.CDLL:
    """The bitmap decoders' library, built at first use and loaded once a
    process, its functions' argtypes declared."""
    global _bitmap
    with _lock:
        if _bitmap is None:
            lib = ctypes.CDLL(build(BITMAP_SOURCES, 'bitmap',
                                    'the bitmap decoders'))
            for name, args in _BITMAP_ABI.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = None if name in _BITMAP_VOID else \
                    ctypes.c_int64 if name in _BITMAP_COUNT else ctypes.c_int
            _bitmap = lib
    return _bitmap


def ptr(a: np.ndarray) -> int:
    """The address of a C-contiguous array's data, for a ``c_void_p``
    argument (the caller keeps the array alive across the call)."""
    if not a.flags['C_CONTIGUOUS']:
        raise ValueError("a native call needs C-contiguous arrays")
    return a.ctypes.data


def _bound():
    global _fn
    with _lock:
        if _fn is None:
            fn = ctypes.CDLL(build()).mnt_build_bvh
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
                ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32)]
            _fn = fn
    return _fn


def build_bvh(v0, e1, e2, leaf_size: int):
    """Binned-SAH BVH of the triangles (v0, e1, e2), numpy (T, 3) float32:
    (lo, hi, a, b, leaf, order) in the layout of ``ops/bvh.BVHArrays``,
    nodes in preorder, ``order`` mapping reordered to original ids."""
    fn = _bound()
    v0, e1, e2 = (np.ascontiguousarray(x, np.float32) for x in (v0, e1, e2))
    T = len(v0)
    cap = 2 * T + 1
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    a = np.empty(cap, np.int32)
    b = np.empty(cap, np.int32)
    leaf = np.empty(cap, np.uint8)
    order = np.empty(T, np.int32)

    def p(arr, ty):
        return arr.ctypes.data_as(ctypes.POINTER(ty))

    M = fn(p(v0, ctypes.c_float), p(e1, ctypes.c_float),
           p(e2, ctypes.c_float), T, leaf_size,
           p(lo, ctypes.c_float), p(hi, ctypes.c_float),
           p(a, ctypes.c_int32), p(b, ctypes.c_int32),
           p(leaf, ctypes.c_uint8), p(order, ctypes.c_int32))
    return lo[:M], hi[:M], a[:M], b[:M], leaf[:M].astype(bool), order

"""Native (C++) host code, built with ``g++`` at first use and loaded with
``ctypes``.

Port of ``mitsuba_nlvrl_tpu/native/__init__.py`` for the BVH builder
(``bvh_native.cpp``, the reference's own source, copied). The library is
compiled with the reference's flags into ``mitsuba_nlvrl_tpu_torch/_build/``
under a name that carries a hash of the source and flags. Unlike the
reference there is no numpy fallback: the tree, and so the triangle order
of every scene from 1,024 triangles, must not depend on whether a compiler
happened to be found, so a failed compile raises with the compiler's
message.
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
SOURCE = os.path.join(_DIR, 'bvh_native.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
# the reference's flags (mitsuba_nlvrl_tpu/native/__init__.py)
CXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC', '-march=native']

_lock = threading.Lock()
_fn = None


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


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    h.update(' '.join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f'libmnt_bvh_{h.hexdigest()[:16]}.so')


def build() -> str:
    """Compile the builder if its library is missing; returns its path.
    Raises RuntimeError carrying the compiler's message on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    cmd = [os.environ.get('CXX', 'g++'), *CXX_FLAGS, SOURCE, '-o', tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the BVH builder failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building the BVH builder failed "
                           f"({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path


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

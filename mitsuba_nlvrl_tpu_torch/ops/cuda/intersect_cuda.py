"""Ray-triangle intersection kernel: wrapper, build and plain version.

Counterpart of ``mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py``. The
kernel (``csrc/intersect.cu``) replaces the TPU kernel ``_mt_kernel``: a
dense rays x triangles Möller-Trumbore sweep with a fused nearest-hit or
any-hit reduction. ``intersect_tris`` takes the kernel on CUDA tensors and
the plain PyTorch version ``intersect_tris_plain`` on CPU tensors; on a
CUDA tensor it launches the kernel or raises.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``mitsuba_nlvrl_tpu_torch/_build/``, under a name that carries a hash of
the source and flags (an edited source is rebuilt), and bound with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import sys
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, 'csrc', 'intersect.cu')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']

# number of kernel launches since the last reset (read by chip_smoke.py to
# show that a render went through the kernel)
launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get('NVCC'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'),
                 shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC")


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'libmnt_intersect_{h.hexdigest()[:16]}.so')


def build(verbose: bool = False) -> str:
    """Compile the kernel if its library is missing; returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report on stderr."""
    path = library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
           '-o', tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    if verbose:
        print(res.stderr, end='', file=sys.stderr)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.mnt_intersect_tris
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 4
                           + [ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def intersect_tris(v0, e1, e2, o, d, mint, maxt, any_hit: bool = False):
    """Nearest (or any) hit of N rays against T triangles.

    v0, e1, e2: (T, 3) float32; o, d: (N, 3); mint, maxt: (N,).
    Returns (t, idx, u, v), each (N,): t float32 (inf on a miss), idx
    int32 (-1 on a miss), u, v float32 barycentrics. With ``any_hit`` only
    t is meaningful: finite exactly when the ray is occluded."""
    global launches
    if o.device.type == 'cpu':
        return intersect_tris_plain(v0, e1, e2, o, d, mint, maxt, any_hit)
    if o.device.type != 'cuda':
        raise ValueError(f"no kernel for device {o.device}")
    T, N = v0.shape[0], o.shape[0]
    dev = o.device
    for name, x, shape in (('v0', v0, (T, 3)), ('e1', e1, (T, 3)),
                           ('e2', e2, (T, 3)), ('o', o, (N, 3)),
                           ('d', d, (N, 3)), ('mint', mint, (N,)),
                           ('maxt', maxt, (N,))):
        _check(name, x, shape, dev)
    t = torch.empty((N,), dtype=torch.float32, device=dev)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    u = torch.empty((N,), dtype=torch.float32, device=dev)
    v = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return t, idx, u, v
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mnt_intersect_tris(
            v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), T, o.data_ptr(),
            d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), N,
            int(bool(any_hit)), t.data_ptr(), idx.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return t, idx, u, v


# elements of one (rays x triangles) plane in the plain sweep
_PLAIN_PLANE = 1 << 22


def _moller_trumbore(o, d, v0, e1, e2):
    """Möller-Trumbore on (R, 1) ray and (1, C) triangle components, in the
    reference's operation order. Returns (t, u, v, hit), each (R, C)."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tx = o[:, 0:1] - v0[None, :, 0]
    ty = o[:, 1:2] - v0[None, :, 1]
    tz = o[:, 2:3] - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
    return t, u, v, hit


def intersect_tris_plain(v0, e1, e2, o, d, mint, maxt, any_hit: bool = False):
    """Plain PyTorch version of the kernel: the chunked sweep of the
    reference's ``_scan_tris``, with the Pallas kernel's outputs (any-hit
    returns the smallest hit t). Runs on any device."""
    T, N = v0.shape[0], o.shape[0]
    dev = o.device
    best_t = torch.full((N,), math.inf, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    chunk = min(1024, max(128, -(-T // 128) * 128))
    ray_block = max(1, _PLAIN_PLANE // chunk)
    for r0 in range(0, N, ray_block):
        rs = slice(r0, min(N, r0 + ray_block))
        ro, rd = o[rs], d[rs]
        rmin, rmax = mint[rs, None], maxt[rs, None]
        bt, bi, bu, bv = best_t[rs], best_i[rs], best_u[rs], best_v[rs]
        for base in range(0, T, chunk):
            ts = slice(base, min(T, base + chunk))
            t, u, v, hit = _moller_trumbore(ro, rd, v0[ts], e1[ts], e2[ts])
            valid = hit & (t >= rmin) & (t <= rmax)
            t = torch.where(valid, t, math.inf)
            tj = t.min(dim=1).values
            if any_hit:
                bt = torch.minimum(bt, tj)
                continue
            # lowest index among the minima (the kernels' tie rule)
            ids = torch.arange(t.shape[1], dtype=torch.int64, device=dev)
            j = torch.where(t == tj[:, None], ids, t.shape[1]).min(dim=1)
            j = torch.clamp(j.values, max=t.shape[1] - 1)[:, None]
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, (base + j[:, 0]).to(torch.int32), bi)
            bu = torch.where(better, u.gather(1, j)[:, 0], bu)
            bv = torch.where(better, v.gather(1, j)[:, 0], bv)
        best_t[rs], best_i[rs], best_u[rs], best_v[rs] = bt, bi, bu, bv
    return best_t, best_i, best_u, best_v

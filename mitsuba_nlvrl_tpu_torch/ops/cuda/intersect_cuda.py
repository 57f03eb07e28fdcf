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
import struct
import sys
import threading
from typing import NamedTuple

import torch

from ...core import counters as _counters

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, 'csrc', 'intersect.cu')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']

# argument types of the C entry points, in the order of their extern "C"
# declarations; the fields of the LaunchArgs struct that mnt_intersect_tris
# takes (one int64 each) and of the Geometry struct that
# mnt_intersect_geometry fills (one int32 each). CPU tests hold all three
# to csrc/intersect.cu.
ARGTYPES = {
    'mnt_intersect_geometry': [ctypes.c_int] * 3 + [ctypes.c_void_p],
    'mnt_intersect_tris': [ctypes.c_void_p],
}
LAUNCH_FIELDS = ('v0', 'e1', 'e2', 'n_tris', 'o', 'd', 'mint', 'maxt',
                 'n_rays', 'any_hit', 't_out', 'i_out', 'u_out', 'v_out',
                 'stream')
_PACK = struct.Struct(f'<{len(LAUNCH_FIELDS)}q')
GEOMETRY_FIELDS = ('grid', 'smem_bytes', 'ring', 'ray_tile')
_GEOMETRY = struct.Struct(f'<{len(GEOMETRY_FIELDS)}i')

# number of kernel launches since the last reset (read by chip_smoke.py to
# show that a render went through the kernel); launches made while
# autograd recomputes a checkpointed function count apart
launches = 0
launches_recompute = 0

_fn = None                # the bound mnt_intersect_tris
_lib = None
_lock = threading.Lock()
_F32 = torch.float32
_local = threading.local()   # a thread's LaunchArgs buffer and its address
_MAX_ROWS = (2**31 - 1) // 3   # 3 * N and 3 * T must fit the kernel's ints


class Geometry(NamedTuple):
    grid: int             # blocks
    smem_bytes: int       # dynamic shared memory a block
    ring: bool            # triangles stream through a ring of tiles
    ray_tile: int         # rays a block takes at a time


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
    global _lib, _fn
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _fn = lib, lib.mnt_intersect_tris
    return _lib


def geometry(n_rays: int, n_tris: int, any_hit: bool = False,
             device=None) -> Geometry:
    """The launch the kernel makes for ``n_rays`` rays against ``n_tris``
    triangles on a CUDA device (the current one by default), as the
    library works it out at each launch."""
    lib = _load()
    buf = ctypes.create_string_buffer(_GEOMETRY.size)
    with torch.cuda.device(device):
        err = lib.mnt_intersect_geometry(n_rays, n_tris, int(any_hit), buf)
    if err != 0:
        raise RuntimeError(f"intersect kernel geometry failed: CUDA error "
                           f"{err}")
    grid, smem, ring, tile = _GEOMETRY.unpack(buf.raw)
    return Geometry(grid, smem, bool(ring), tile)


def _public_raw_stream(dev_index: int) -> int:
    return torch.cuda.current_stream(dev_index).cuda_stream


# the current stream's handle and the current device, by PyTorch's own
# C bindings where this build has them (a CPU build has neither)
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream',
                      _public_raw_stream)
_current_device = getattr(torch._C, '_cuda_getDevice',
                          torch.cuda.current_device)


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


def _explain(v0, e1, e2, o, d, mint, maxt):
    """Raise the error that names the first argument the kernel refuses."""
    T, N, dev = v0.shape[0], o.shape[0], o.device
    for name, x, shape in (('v0', v0, (T, 3)), ('e1', e1, (T, 3)),
                           ('e2', e2, (T, 3)), ('o', o, (N, 3)),
                           ('d', d, (N, 3)), ('mint', mint, (N,)),
                           ('maxt', maxt, (N,))):
        _check(name, x, shape, dev)
    raise ValueError(f"{N} rays, {T} triangles: the kernel takes at most "
                     f"{_MAX_ROWS} of each")


def _args_ok(v0, e1, e2, o, d, mint, maxt, T, N, dev) -> bool:
    """Whether the kernel takes these arguments (one pass, no tuples of
    tensors; _explain says what is wrong)."""
    tri_shape, ray_shape = (T, 3), (N, 3)
    return (v0.shape == tri_shape and e1.shape == tri_shape
            and e2.shape == tri_shape and o.shape == ray_shape
            and d.shape == ray_shape and mint.shape == (N,)
            and maxt.shape == (N,) and N <= _MAX_ROWS and T <= _MAX_ROWS
            and v0.dtype is _F32 and e1.dtype is _F32 and e2.dtype is _F32
            and o.dtype is _F32 and d.dtype is _F32 and mint.dtype is _F32
            and maxt.dtype is _F32 and v0.device == dev and e1.device == dev
            and e2.device == dev and d.device == dev and mint.device == dev
            and maxt.device == dev and v0.is_contiguous()
            and e1.is_contiguous() and e2.is_contiguous()
            and o.is_contiguous() and d.is_contiguous()
            and mint.is_contiguous() and maxt.is_contiguous())


def intersect_tris(v0, e1, e2, o, d, mint, maxt, any_hit: bool = False):
    """Nearest (or any) hit of N rays against T triangles.

    v0, e1, e2: (T, 3) float32; o, d: (N, 3); mint, maxt: (N,).
    Returns (t, idx, u, v), each (N,): t float32 (inf on a miss), idx
    int32 (-1 on a miss), u, v float32 barycentrics. With ``any_hit`` only
    t is computed: finite exactly when the ray is occluded; idx, u and v
    are None."""
    global launches, launches_recompute
    dev = o.device
    if dev.type == 'cpu':
        return intersect_tris_plain(v0, e1, e2, o, d, mint, maxt, any_hit)
    if dev.type != 'cuda':
        raise ValueError(f"no kernel for device {dev}")
    T, N = v0.shape[0], o.shape[0]
    if not _args_ok(v0, e1, e2, o, d, mint, maxt, T, N, dev):
        _explain(v0, e1, e2, o, d, mint, maxt)
    # four allocations like mint (N,) cost the host less than one buffer
    # and four views (scripts/port_kernel_compare.py, host_pieces)
    t = torch.empty_like(mint)
    if any_hit:
        idx = u = v = None
    else:
        idx = torch.empty_like(mint, dtype=torch.int32)
        u = torch.empty_like(mint)
        v = torch.empty_like(mint)
    if N == 0:
        return t, idx, u, v
    if _fn is None:
        _load()
    di = dev.index
    packed = getattr(_local, 'packed', None)
    if packed is None:
        buf = ctypes.create_string_buffer(_PACK.size)
        packed = _local.packed = (buf, ctypes.addressof(buf))
    _PACK.pack_into(packed[0], 0, v0.data_ptr(), e1.data_ptr(),
                    e2.data_ptr(), T, o.data_ptr(), d.data_ptr(),
                    mint.data_ptr(), maxt.data_ptr(), N, int(any_hit),
                    t.data_ptr(),
                    0 if any_hit else idx.data_ptr(),
                    0 if any_hit else u.data_ptr(),
                    0 if any_hit else v.data_ptr(), _raw_stream(di))
    if di == _current_device():
        err = _fn(packed[1])
    else:
        with torch.cuda.device(di):
            err = _fn(packed[1])
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{err}")
    if _counters.recomputing:
        launches_recompute += 1
    else:
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
    reference's ``_scan_tris``, with the kernel's outputs (any hit returns
    the smallest hit t and None for idx, u and v). Runs on any device."""
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
    if any_hit:
        return best_t, None, None, None
    return best_t, best_i, best_u, best_v

"""Ray-triangle intersection kernel: wrapper, build and plain version.

Counterpart of ``mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py``. The
kernel (``csrc/intersect.cu``) replaces the TPU kernel ``_mt_kernel``: a
dense rays x triangles Möller-Trumbore sweep with a fused nearest-hit or
any-hit reduction. The double variant's scenes take a second kernel of
the same contract in float64 (``csrc/intersect_f64.cu``), chosen by the
arguments' dtype. ``intersect_tris`` takes a kernel on CUDA tensors and
the plain PyTorch version ``intersect_tris_plain`` (float32 or float64)
on CPU tensors; on a CUDA tensor it launches the kernel or raises.

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use into
``mitsuba_nlvrl_tpu_torch/_build/`` (one nvcc a source, started
together), under names that carry a hash of the source and flags (an
edited source is rebuilt), and bound with ``ctypes``.
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
SOURCE_F64 = os.path.join(_PKG, 'csrc', 'intersect_f64.cu')
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
ARGTYPES_F64 = {'mnt_intersect_tris_f64': [ctypes.c_void_p]}
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
# the same for the float64 kernel
launches_f64 = 0
launches_f64_recompute = 0

_F32 = torch.float32
_F64 = torch.float64
# a float type's kernel: its source, its entry points' argument types, the
# entry point that launches it, and its two counters above
_KERNELS = {
    _F32: (SOURCE, ARGTYPES, 'mnt_intersect_tris', 'launches',
           'launches_recompute'),
    _F64: (SOURCE_F64, ARGTYPES_F64, 'mnt_intersect_tris_f64',
           'launches_f64', 'launches_f64_recompute'),
}
_fns = {}                 # float type -> its bound entry point
_count = globals()        # the counters, by name
_lib = None               # the float32 library (it answers geometry())
_lock = threading.Lock()
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


def library_path(source: str = SOURCE) -> str:
    h = hashlib.sha256()
    with open(source, 'rb') as f:
        h.update(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f'libmnt_{stem}_{h.hexdigest()[:16]}.so')


def build(verbose: bool = False, sources=(SOURCE, SOURCE_F64)) -> str:
    """Compile those of ``sources`` whose libraries are missing, one nvcc
    a source started together; returns the first source's library path.
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's reports on stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in sources:
        path = library_path(src)
        if os.path.exists(path) and not verbose:
            continue
        tmp = f'{path}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
               '-o', tmp, src]
        jobs.append((path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for path, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, path)
        if verbose:
            print(err, end='', file=sys.stderr)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return library_path(sources[0])


def _bind(path: str, argtypes: dict):
    lib = ctypes.CDLL(path)
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _load(dtype=_F32):
    """Build and bind the kernel of float type ``dtype`` at its first use;
    returns its entry point."""
    global _lib
    with _lock:
        if dtype not in _fns:
            source, argtypes, entry = _KERNELS[dtype][:3]
            build(sources=(source,))
            lib = _bind(library_path(source), argtypes)
            if dtype is _F32:
                _lib = lib
            _fns[dtype] = getattr(lib, entry)
    return _fns[dtype]


def geometry(n_rays: int, n_tris: int, any_hit: bool = False,
             device=None) -> Geometry:
    """The launch the kernel makes for ``n_rays`` rays against ``n_tris``
    triangles on a CUDA device (the current one by default), as the
    library works it out at each launch."""
    _load()
    lib = _lib
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


def _check(name, x, shape, device, dtype):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} as v0 is (float32 or "
                        f"float64), got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _explain(v0, e1, e2, o, d, mint, maxt):
    """Raise the error that names the first argument the kernel refuses."""
    T, N, dev = v0.shape[0], o.shape[0], o.device
    dtype = v0.dtype if v0.dtype in (_F32, _F64) else _F32
    for name, x, shape in (('v0', v0, (T, 3)), ('e1', e1, (T, 3)),
                           ('e2', e2, (T, 3)), ('o', o, (N, 3)),
                           ('d', d, (N, 3)), ('mint', mint, (N,)),
                           ('maxt', maxt, (N,))):
        _check(name, x, shape, dev, dtype)
    raise ValueError(f"{N} rays, {T} triangles: the kernel takes at most "
                     f"{_MAX_ROWS} of each")


def _args_ok(v0, e1, e2, o, d, mint, maxt, T, N, dev) -> bool:
    """Whether a kernel takes these arguments, all float32 or all float64
    (one pass, no tuples of tensors; _explain says what is wrong)."""
    tri_shape, ray_shape = (T, 3), (N, 3)
    ft = v0.dtype
    return (v0.shape == tri_shape and e1.shape == tri_shape
            and e2.shape == tri_shape and o.shape == ray_shape
            and d.shape == ray_shape and mint.shape == (N,)
            and maxt.shape == (N,) and N <= _MAX_ROWS and T <= _MAX_ROWS
            and (ft is _F32 or ft is _F64) and e1.dtype is ft
            and e2.dtype is ft and o.dtype is ft and d.dtype is ft
            and mint.dtype is ft and maxt.dtype is ft and v0.device == dev and e1.device == dev
            and e2.device == dev and d.device == dev and mint.device == dev
            and maxt.device == dev and v0.is_contiguous()
            and e1.is_contiguous() and e2.is_contiguous()
            and o.is_contiguous() and d.is_contiguous()
            and mint.is_contiguous() and maxt.is_contiguous())


def intersect_tris(v0, e1, e2, o, d, mint, maxt, any_hit: bool = False):
    """Nearest (or any) hit of N rays against T triangles.

    v0, e1, e2: (T, 3); o, d: (N, 3); mint, maxt: (N,), all float32 (the
    float32 kernel) or all float64 (the float64 kernel). Returns (t, idx,
    u, v), each (N,): t (inf on a miss), idx int32 (-1 on a miss), u, v
    barycentrics, in the arguments' float type. With ``any_hit`` only t is
    computed: finite exactly when the ray is occluded; idx, u and v are
    None."""
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
    ft = v0.dtype
    fn = _fns.get(ft) or _load(ft)
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
        err = fn(packed[1])
    else:
        with torch.cuda.device(di):
            err = fn(packed[1])
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{err}")
    counter = _KERNELS[ft][4 if _counters.recomputing else 3]
    _count[counter] += 1
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
    best_t = torch.full((N,), math.inf, dtype=o.dtype, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((N,), dtype=o.dtype, device=dev)
    best_v = torch.zeros((N,), dtype=o.dtype, device=dev)
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

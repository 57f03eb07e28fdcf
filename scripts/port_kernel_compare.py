"""The port's ray-triangle kernels against other versions of them, on one
GPU, in one process.

    python3 scripts/port_kernel_compare.py --parent DIR \
        [--variant TAG=DIR ...] [--dtype float32|float64] [--out DIR]

--dtype picks the kernel: `csrc/intersect.cu` (float32, the default) or
`csrc/intersect_f64.cu` (float64, the double variant's). Each DIR is the
root of another checkout of the repository: --parent the parent commit
(for example unpacked with `git archive`), each --variant a copy of this
checkout with the kernel changed (for example one constant edited). Its
`mitsuba_nlvrl_tpu_torch/ops/cuda/intersect_cuda.py` is loaded under
another package name and binds its own kernel from its own `_build/`;
every version is compiled at the start, one nvcc each, started together.
Prints JSON lines:

  build     nvcc's -Xptxas -v report (registers, shared memory, spills) of
            every version, and the card's name and power limit
  sass      per kernel function of every version: SASS instructions and
            the count of each opcode (`cuobjdump -sass`), and (float32) the
            instructions a ray-triangle pair; the full listings go to --out
  check     every version against the plain version: idx and the bits of
            t, u, v (nearest hit); any hit the bits of t (float64, which
            writes the smallest hit t) or occlusion (float32). float32 on
            the two timed shapes, float64 on every chip_smoke.f64_cases case
  scan      parent and change against the triangle count at the main
            path's rays
  floors    a device copy of the kernel's bytes, a one-element launch
  host_pieces  host time of the pieces of a wrapper call
  time      device time of one call (CUDA graph replay, as chip_smoke.py
            times it), at 262,144 Cornell-box camera rays x 12 triangles and
            262,144 random rays x 1,023 random triangles, nearest and any
            hit, in the order parent, change, variants, change, parent
  render_rays  the calls of one pass of the 512x512, 16 spp Cornell box
            (`cbox_path`; in float64 `cbox_path_double`), each checked,
            then timed together and by kind (the bounce rays' nearest-hit
            calls, the shadow-ray calls), device ms a launch
  render    that render end to end, wall seconds, with each version's
            wrapper in place of the port's, in the same order; the images
            equal in bits
  l2        the camera-ray call on the same rays again and again against
            the same call on 16 distinct copies of them (L2-resident or
            not)
  host      host time a wrapper call (parent, change, change, parent)

Exits 1 if a version disagrees with the plain version or the renders
differ.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (bound as bound_of, f64_cases,  # noqa: E402
                        host_ms, peaks, record_calls, time_ms)
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern  # noqa

# triangle counts of the scan over T (the Cornell box's 12, cycled)
SCAN_TRIS = (0, 2, 6, 12, 24, 48)


def emit(obj):
    print(json.dumps(obj), flush=True)


def load_other(root: str, tag: str):
    """The intersect_cuda module of the checkout at ``root``, imported as
    ``_cmp_<tag>.ops.cuda.intersect_cuda`` (its relative imports resolve
    inside that checkout; no package __init__ runs)."""
    pkg, name = os.path.join(root, 'mitsuba_nlvrl_tpu_torch'), f'_cmp_{tag}'
    for sub in ((), ('core',), ('ops',), ('ops', 'cuda')):
        mod = types.ModuleType('.'.join((name, *sub)))
        mod.__path__ = [os.path.join(pkg, *sub)]
        sys.modules[mod.__name__] = mod
    full = f'{name}.ops.cuda.intersect_cuda'
    spec = importlib.util.spec_from_file_location(
        full, os.path.join(pkg, 'ops', 'cuda', 'intersect_cuda.py'))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def build_all(mods: dict, dtype) -> dict:
    """Compile every version's kernel of float type ``dtype`` into the
    library its module loads, with -Xptxas -v, one nvcc each, started
    together: {tag: (library path, ptxas report lines)}."""
    attr = 'SOURCE_F64' if dtype is torch.float64 else 'SOURCE'
    procs = {}
    for tag, mod in mods.items():
        src = getattr(mod, attr)
        path = mod.library_path(src)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cmd = [mod._nvcc(), *mod.NVCC_FLAGS, '-Xptxas', '-v', '-o',
               f'{path}.tmp', src]
        procs[tag] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for tag, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{err}")
        os.replace(f'{path}.tmp', path)
        out[tag] = (path, [ln.strip() for ln in err.splitlines()
                           if 'registers' in ln or 'spill' in ln
                           or 'Compiling' in ln])
    return out


def _addr(line: str) -> int:
    return int(re.match(r'/\*([0-9a-f]+)\*/', line).group(1), 16)


def _branch_target(line: str) -> int:
    return int(re.search(r'BRA (?:[!\w]+, )?0x([0-9a-f]+)', line).group(1), 16)


def pair_cost(lines: list) -> dict:
    """Issued instructions of one ray-triangle pair on the fast path, read
    from the float32 nearest-hit kernel's SASS (``lines``, one instruction
    each): the code of one triangle against the thread's rays (from one
    group of LDS.128 to the next), less the slow reciprocal the first vote
    skips, over the rays (one MUFU.RCP each on the fast path); the
    instructions up to the vote after u and after v are the cost of a pair
    that leaves there."""
    loads = [i for i, x in enumerate(lines) if 'LDS.128' in x]
    block = lines[loads[0]:loads[2]]
    votes = [i for i, x in enumerate(block) if 'VOTE.ANY P' in x]
    if len(votes) < 3:      # a variant without vote exits: not counted
        return None
    skip = next(j for j in range(votes[0], len(block)) if 'BRA' in block[j])
    target = _branch_target(block[skip])
    resume = next(j for j, x in enumerate(block) if _addr(x) == target)
    slow = resume - skip - 1
    rays = sum('MUFU.RCP' in x for x in block[:skip + 1] + block[resume:])
    return {'rays': rays, 'full': (len(block) - slow) / rays,
            'exit_after_u': (votes[1] + 2 - slow) / rays,
            'exit_after_v': (votes[2] + 2 - slow) / rays}


def sass(path: str, tag: str, out_dir: str, with_pair_cost: bool) -> dict:
    cuobjdump = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                             'bin', 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', path], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(out_dir, f'sass_{tag}.txt'), 'w') as f:
        f.write(text)
    kernels, listings, cur = {}, {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            cur = kernels.setdefault(m.group(1), collections.Counter())
            listing = listings.setdefault(m.group(1), [])
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)',
                     line)
        if m and cur is not None:
            cur[m.group(2).split('.')[0]] += 1
            listing.append(re.sub(r'\s+/\* 0x.*', '', line.strip()))
    out = {k: {'instructions': sum(c.values()), 'opcodes': dict(c)}
           for k, c in kernels.items()}
    for k, listing in listings.items():
        if with_pair_cost and 'ILb0ELb0E' in k:   # nearest hit, whole set
            out[k]['pair_cost'] = pair_cost(listing)
    return out


def main_scene(dtype):
    """The main path's Cornell box, 512x512, 16 spp, ``path`` max_depth 8
    (``cbox_path``; ``cbox_path_double`` in float64), on the card."""
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.testing.scenes import (cbox_light_spd,
                                                        cornell_box)
    desc = cornell_box(spp=16, res=512,
                       integrator={'type': 'path', 'max_depth': 8},
                       radiance=cbox_light_spd())
    desc['double'] = dtype is torch.float64
    scene, meta = mnt.build_scene(desc)
    assert scene.dtype == dtype
    return scene, meta


def cases_f32(scene, meta) -> dict:
    """The two timed shapes in float32: the box's camera rays and random
    rays against 1,023 random triangles, {name: (tris, rays)}."""
    from mitsuba_nlvrl_tpu_torch import sensor
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions
    dev = scene.device
    pos_key, _ = rng.split(rng.fold_in(rng.PRNGKey(0), 0))
    _, pos01 = film_sample_positions(meta, pos_key, 0, dev)
    cam, _ = sensor.sample_ray(scene, meta, pos01, None)
    g = scene.geo
    gen = torch.Generator(device=dev).manual_seed(99)

    def rand(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)
    big = (rand(1023, 3, lo=-1.0, hi=1.0), rand(1023, 3, lo=-0.6, hi=0.6),
           rand(1023, 3, lo=-0.6, hi=0.6))
    o = rand(262144, 3, lo=-3.0, hi=3.0)
    d = rand(262144, 3, lo=-1.0, hi=1.0) - o
    big_rays = (o, (d / d.norm(dim=1, keepdim=True)).contiguous(),
                torch.full((262144,), 1e-4, device=dev),
                torch.full((262144,), math.inf, device=dev))
    return {'cbox_camera_512': ((g.v0, g.e1, g.e2),
                                tuple(x.contiguous() for x in (
                                    cam.o, cam.d, cam.mint, cam.maxt))),
            'random_1023': (big, big_rays)}


def mismatches(got, ref, any_hit: bool) -> int:
    """Entries in which a kernel's (t, idx, u, v) differ from the plain
    version's: the bits of t, u, v and idx (nearest hit); any hit the
    bits of t in float64 (the smallest hit t), occlusion in float32 (the
    float32 kernel stops at the first hit)."""
    def bits(x):
        return x.view(torch.int64 if x.dtype == torch.float64
                      else torch.int32)
    if any_hit:
        if got[0].dtype == torch.float64:
            return int((bits(got[0]) != bits(ref[0])).sum())
        return int((torch.isfinite(got[0]) != torch.isfinite(ref[0])).sum())
    return (sum(int((bits(a) != bits(b)).sum())
                for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                             (got[3], ref[3])))
            + int((got[1] != ref[1]).sum()))


def scan(case, callers, bw, fl, fb, smi):
    """Device time against the triangle count, at the main path's 262,144
    camera rays: the intercept is the kernel's cost with no pair to test
    (launch, ray loads, stores), the slope the cost of a triangle."""
    (v0, e1, e2), rays = case
    N = rays[0].shape[0]
    for T in SCAN_TRIS:
        k = torch.arange(T, device=v0.device) % v0.shape[0]
        tris = (v0[k].contiguous(), e1[k].contiguous(), e2[k].contiguous())
        runs = {}
        for tag in ('parent', 'change', 'change', 'parent'):
            ms = time_ms(lambda: callers[tag](*tris, *rays), 7, 50)
            runs.setdefault(tag, []).append(ms)
        bound = max(bound_of(N, T, False, bw, fl, fb)[2:])
        emit({'phase': 'scan', 'rays': N, 'tris': T, 'bound_ms': bound,
              'ms': runs, 'nvidia_smi': smi})


def floors(case, bw, fb, smi):
    """Yardsticks at the main path's bytes: a device copy that moves as
    many bytes as the kernel (read half, write half), and an empty launch
    in a CUDA graph."""
    _, rays = case
    nbytes = bound_of(rays[0].shape[0], 12, False, bw, 1.0, fb)[0]
    src = torch.empty(nbytes // 8, device=rays[0].device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 7, 50)
    tiny = torch.empty(1, device=rays[0].device)
    empty_ms = time_ms(lambda: tiny.add_(0), 7, 50)
    moved = 2 * src.numel() * 4
    emit({'phase': 'floors', 'bytes': moved, 'copy_ms': copy_ms,
          'copy_gb_per_s': moved / copy_ms / 1e6,
          'bytes_bound_ms': moved / bw * 1e3,
          'one_element_add_ms': empty_ms, 'nvidia_smi': smi})


def host_pieces(case, smi, calls=2000):
    """Host time of the pieces of a wrapper call, in µs, at the main path's
    shape: the checks, the four outputs (four allocations, or one buffer
    and four views), packing the launch arguments, the launch through
    ctypes (launch geometry included), the whole call (device work queued,
    not waited for), the stream handle by PyTorch's public and its C
    binding."""
    (v0, e1, e2), (o, d, mint, maxt) = case
    T, N, dev = v0.shape[0], o.shape[0], o.device
    outputs = [torch.empty_like(mint) for _ in range(4)]
    out_ptrs = [x.data_ptr() for x in outputs]
    packed = ctypes.create_string_buffer(kern._PACK.size)
    launch = kern._load(v0.dtype)

    def pack():
        kern._PACK.pack_into(
            packed, 0, v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), T,
            o.data_ptr(), d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), N,
            0, *out_ptrs, kern._raw_stream(dev.index))

    def one_buffer_views():
        buf = torch.empty((4, N), device=dev, dtype=mint.dtype)
        _, i, _, _ = buf.unbind(0)
        i.view(torch.int32)

    def four_empty_like():
        torch.empty_like(mint)
        torch.empty_like(mint, dtype=torch.int32)
        torch.empty_like(mint)
        torch.empty_like(mint)
    pack()
    pieces = {'checks': lambda: kern._args_ok(v0, e1, e2, o, d, mint, maxt,
                                              T, N, dev),
              'four_empty_like': four_empty_like,
              'one_buffer_views': one_buffer_views,
              'pack': pack,
              'launch': lambda: launch(ctypes.addressof(packed)),
              'wrapper_call': lambda: kern.intersect_tris(v0, e1, e2, o, d,
                                                          mint, maxt),
              'current_stream': lambda: torch.cuda.current_stream(
                  dev).cuda_stream,
              'raw_stream': lambda: kern._raw_stream(dev.index)}
    us = {}
    for name, fn in pieces.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    emit({'phase': 'host_pieces', 'us': us, 'nvidia_smi': smi})


def l2(case, callers, smi, copies=16):
    """The camera-ray call repeated on one copy of its rays (which then
    stays in the 50 MB L2 cache) against the same call on ``copies``
    distinct copies (read from device memory each time), device ms a
    launch, parent and change."""
    tris, rays = case
    distinct = [tuple(x.clone() for x in rays) for _ in range(copies)]
    runs = []
    for tag in ('parent', 'change', 'change', 'parent'):
        runs.append({'version': tag, 'same_rays_ms': time_ms(
            lambda: [callers[tag](*tris, *rays) for _ in distinct], 7, 5)
            / copies, 'distinct_rays_ms': time_ms(
            lambda: [callers[tag](*tris, *r) for r in distinct], 7, 5)
            / copies})
    emit({'phase': 'l2', 'copies': copies, 'runs': runs, 'nvidia_smi': smi})


def render_rays(calls, callers, order, bw, fl, fb, smi) -> int:
    """Every version on the calls of one pass of the render: checked call
    by call against the plain version, then the pass's calls timed
    together and by kind (the nearest-hit calls on bounce rays, after the
    camera rays' first; the shadow-ray calls), device ms a launch.
    Returns the mismatches."""
    bad = collections.Counter()
    for tris, rays, any_hit in calls:
        ref = kern.intersect_tris_plain(*tris, *rays, any_hit=any_hit)
        for tag, c in callers.items():
            bad[tag] += mismatches(c(*tris, *rays, any_hit=any_hit), ref,
                                   any_hit)
    emit({'phase': 'render_rays_check', 'calls': len(calls),
          'mismatches': dict(bad)})
    groups = {'pass': calls, 'bounce_nearest': calls[2::2],
              'shadow_any_hit': calls[1::2]}
    for name, group in groups.items():
        bound = sum(max(bound_of(r[0].shape[0], t[0].shape[0], a, bw, fl,
                                 fb)[2:]) for t, r, a in group) / len(group)
        runs = []
        for tag in order:
            ms = time_ms(lambda: [callers[tag](*t, *r, any_hit=a)
                                  for t, r, a in group], 7, 5) / len(group)
            runs.append({'version': tag, 'ms_per_launch': ms,
                         'roofline_share': bound / ms})
        emit({'phase': 'render_rays', 'calls': name, 'launches':
              len(group), 'bound_ms_per_launch': bound, 'runs': runs,
              'nvidia_smi': smi})
    return sum(bad.values())


def render(scene, meta, callers, order, smi) -> int:
    """The render end to end (wall seconds, synchronised) with each
    version's wrapper in the port's place, after a 1-spp pass to warm it
    up; returns the number of versions whose image differs from the
    first's."""
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
    real, runs, first, differ = pisect.intersect_tris, [], None, 0
    for tag in order:
        pisect.intersect_tris = callers[tag]
        try:
            mnt.render(scene, meta, seed=0, spp=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = mnt.render(scene, meta, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pisect.intersect_tris = real
        first = img if first is None else first
        same = bool(torch.equal(img, first))
        differ += not same
        runs.append({'version': tag, 'wall_s': wall, 'equal_bits': same})
    emit({'phase': 'render', 'spp': meta.spp, 'dtype': str(scene.dtype),
          'runs': runs, 'nvidia_smi': smi})
    return differ


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True)
    ap.add_argument('--variant', action='append', default=[],
                    metavar='TAG=DIR')
    ap.add_argument('--dtype', choices=('float32', 'float64'),
                    default='float32')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    dtype = getattr(torch, args.dtype)
    f64 = dtype is torch.float64

    mods = {'parent': load_other(args.parent, 'parent'), 'change': kern}
    for spec in args.variant:
        tag, root = spec.split('=', 1)
        mods[tag] = load_other(root, tag)
    built = build_all(mods, dtype)
    emit({'phase': 'build', 'nvidia_smi': smi, 'name': name,
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'dtype': args.dtype,
          'ptxas': {t: r for t, (_, r) in built.items()}})
    for tag, (path, _) in built.items():
        emit({'phase': 'sass', 'library': tag, 'kernels': sass(
            path, f"{tag}{'_f64' if f64 else ''}", args.out, not f64)})
    callers = {tag: mod.intersect_tris for tag, mod in mods.items()}

    bw, fl32, fl64 = peaks(name)
    fl, fb = (fl64, 8) if f64 else (fl32, 4)
    variants = [t for t in mods if t not in ('parent', 'change')]
    order = ['parent', 'change'] + variants + ['change', 'parent']
    scene, meta = main_scene(dtype)
    cases = (f64_cases(torch, kern, scene, meta) if f64
             else cases_f32(scene, meta))
    failed = 0
    for case, (tris, rays) in cases.items():
        for any_hit in (False, True):
            ref = kern.intersect_tris_plain(*tris, *rays, any_hit=any_hit)
            bad = {t: mismatches(c(*tris, *rays, any_hit=any_hit), ref,
                                 any_hit) for t, c in callers.items()}
            failed += sum(bad.values())
            emit({'phase': 'check', 'case': case, 'any_hit': any_hit,
                  'rays': rays[0].shape[0], 'tris': tris[0].shape[0],
                  'hits': int(torch.isfinite(ref[0]).sum()),
                  'mismatches': bad})

    camera = cases['cbox_camera_512']
    scan(camera, callers, bw, fl, fb, smi)
    floors(camera, bw, fb, smi)
    host_pieces(camera, smi)
    for shape in ('cbox_camera_512', 'random_1023'):
        tris, rays = cases[shape]
        N, T = rays[0].shape[0], tris[0].shape[0]
        for any_hit in (False, True):
            _, _, b_bytes, b_ops = bound_of(N, T, any_hit, bw, fl, fb)
            bound = max(b_bytes, b_ops)
            runs = []
            for tag in order:
                ms = time_ms(lambda: callers[tag](*tris, *rays,
                                                  any_hit=any_hit), 7, 50)
                runs.append({'version': tag, 'ms': ms,
                             'roofline_share': bound / ms})
            emit({'phase': 'time', 'shape': shape, 'rays': N, 'tris': T,
                  'any_hit': any_hit, 'bound_ms': bound,
                  'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
                  'runs': runs, 'geometry': kern.geometry(
                      N, T, any_hit, dtype=dtype)._asdict(),
                  'nvidia_smi': smi})
    import mitsuba_nlvrl_tpu_torch as mnt
    failed += render_rays(record_calls(mnt, scene, meta), callers, order,
                          bw, fl, fb, smi)
    failed += render(scene, meta, callers, order, smi)
    l2(camera, callers, smi)
    for shape, (tris, rays) in cases.items():
        if shape not in ('cbox_camera_512', 'random_1023'):
            continue
        host = []
        for tag in ('parent', 'change', 'change', 'parent'):
            host.append({'version': tag, 'host_ms_per_call': host_ms(
                lambda: callers[tag](*tris, *rays), 200),
                'host_ms_per_call_any_hit': host_ms(
                lambda: callers[tag](*tris, *rays, any_hit=True), 200)})
        emit({'phase': 'host', 'shape': shape, 'runs': host,
              'nvidia_smi': smi})
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())

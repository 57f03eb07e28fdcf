"""The port's ray-triangle kernel against other versions of it, on one
GPU, in one process.

    python3 scripts/port_kernel_compare.py --parent DIR \
        [--variant TAG=DIR ...] [--out DIR]

Each DIR is the root of another checkout of the repository: --parent the
parent commit (for example unpacked with `git archive`), each --variant a
copy of this checkout with the kernel changed (for example one constant of
`csrc/intersect.cu` edited). Its `mitsuba_nlvrl_tpu_torch/ops/cuda/
intersect_cuda.py` is loaded under another name and builds its own kernel
into its own `_build/`. Prints JSON lines:

  build     nvcc's -Xptxas -v report (registers, shared memory, spills) of
            every library, and the card's name and power limit
  sass      per kernel function of every library: SASS instructions and
            the count of each opcode (`cuobjdump -sass`), and for the
            parent and this checkout the instructions a ray-triangle
            pair; the full listings go to --out
  scan      parent and change against the triangle count at the main
            path's rays
  floors    a device copy of the kernel's bytes, a one-element launch
  host_pieces  host time of the pieces of a wrapper call
  check     every version against this checkout's kernel: idx and the
            bits of t, u, v equal (nearest hit), occlusion equal (any hit)
  time      device time of one call (CUDA graph replay, as chip_smoke.py
            times it), at 262,144 Cornell-box camera rays x 12 triangles and
            262,144 random rays x 1,023 random triangles, nearest and any
            hit, in the order parent, change, variants, change, parent
  render_rays  the same for the calls of one pass of the 512x512 render
            (chip_smoke.render_calls): the pass's 16 calls together, its
            bounce rays' nearest-hit calls and its shadow-ray calls
  l2        the camera-ray call on the same rays again and again against
            the same call on 16 distinct copies of them (L2-resident or
            not)
  host      host time a wrapper call (parent, change, change, parent)
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (FLOPS_PER_PAIR, bound as bound_of,  # noqa: E402
                        host_ms, peaks, render_calls, time_ms)
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern  # noqa

# triangle counts of the scan over T (the Cornell box's 12, cycled)
SCAN_TRIS = (0, 2, 6, 12, 24, 48)


def emit(obj):
    print(json.dumps(obj), flush=True)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_report(build):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        path = build(verbose=True)
    return path, [ln for ln in err.getvalue().splitlines()
                  if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]


def _addr(line: str) -> int:
    return int(re.match(r'/\*([0-9a-f]+)\*/', line).group(1), 16)


def _branch_target(line: str) -> int:
    return int(re.search(r'BRA (?:[!\w]+, )?0x([0-9a-f]+)', line).group(1), 16)


def pair_cost(lines: list, parent: bool) -> dict:
    """Issued instructions of one ray-triangle pair on the fast path, read
    from a nearest-hit kernel's SASS (``lines``, one instruction each).

    Parent: the body of the first triangle loop (from the target of its
    backward branch to that branch), less the out-of-line slow reciprocal
    (from the instruction before CALL.REL to the next BRA), for one ray.
    Redesign: the code of one triangle against the thread's rays (from
    one group of LDS.128 to the next), less the slow reciprocal the first
    vote skips, over the rays (one MUFU.RCP each on the fast path); the
    instructions up to the vote after u and after v are the cost of a
    pair that leaves there."""
    if parent:
        for i, line in enumerate(lines):
            if 'BRA' in line and _branch_target(line) < _addr(line):
                top = [j for j, x in enumerate(lines)
                       if _addr(x) == _branch_target(line)][0]
                body = lines[top:i + 1]
                break
        call = [j for j, x in enumerate(body) if 'CALL.REL' in x][0]
        end = next(j for j in range(call, len(body)) if 'BRA' in body[j])
        return {'rays': 1, 'full': len(body) - (end - call + 2)}
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


def sass(path: str, tag: str, out_dir: str) -> dict:
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
        # the parent's one kernel; the others' nearest-hit whole-set one
        if tag == 'parent' or 'ILb0ELb0E' in k:
            out[k]['pair_cost'] = pair_cost(listing, tag == 'parent')
    return out


def shapes(dev):
    """The timed shapes, and the calls of one pass of the main path's
    render."""
    import mitsuba_nlvrl_tpu_torch as mnt
    from mitsuba_nlvrl_tpu_torch import sensor
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.integrators.common import \
        film_sample_positions
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    scene, meta = mnt.build_scene(cornell_box(
        spp=16, res=512, integrator={'type': 'path', 'max_depth': 8}))
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
    cases = {'cbox_camera_512': ((g.v0, g.e1, g.e2),
                                 (cam.o, cam.d, cam.mint, cam.maxt)),
             'random_1023': (big, big_rays)}
    return cases, render_calls(mnt, scene, meta)


def scan(case, callers, bw, fl, smi):
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
        bound = max((N * 48 + 36 * T) / bw, FLOPS_PER_PAIR * N * T / fl) * 1e3
        emit({'phase': 'scan', 'rays': N, 'tris': T, 'bound_ms': bound,
              'ms': runs, 'nvidia_smi': smi})


def floors(case, bw, smi):
    """Yardsticks at the main path's bytes: a device copy that moves as
    many bytes as the kernel (read half, write half), and an empty launch
    in a CUDA graph."""
    _, rays = case
    nbytes = rays[0].shape[0] * 48 + 36 * 12
    src = torch.empty(nbytes // 8, device=rays[0].device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 7, 50)
    tiny = torch.empty(1, device=rays[0].device)
    empty_ms = time_ms(lambda: tiny.add_(0), 7, 50)
    emit({'phase': 'floors', 'bytes': 2 * src.numel() * 4,
          'copy_ms': copy_ms, 'copy_gb_per_s': 2 * src.numel() * 4
          / copy_ms / 1e6, 'bytes_bound_ms': 2 * src.numel() * 4 / bw * 1e3,
          'one_element_add_ms': empty_ms, 'nvidia_smi': smi})


def host_pieces(case, smi, calls=2000):
    """Host time of the pieces of a wrapper call, in µs, at the main path's
    shape: the checks, the four outputs (four allocations, or one buffer
    and four views), packing the launch arguments, the launch through
    ctypes (launch geometry included), the whole call (device work queued,
    not waited for), the stream handle by PyTorch's public and its C
    binding."""
    import time
    (v0, e1, e2), (o, d, mint, maxt) = case
    T, N, dev = v0.shape[0], o.shape[0], o.device
    outputs = [torch.empty_like(mint) for _ in range(4)]
    out_ptrs = [x.data_ptr() for x in outputs]
    packed = ctypes.create_string_buffer(kern._PACK.size)
    launch = kern._load()

    def pack():
        kern._PACK.pack_into(
            packed, 0, v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), T,
            o.data_ptr(), d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), N,
            0, *out_ptrs, kern._raw_stream(dev.index))

    def one_buffer_views():
        buf = torch.empty((4, N), device=dev)
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
    distinct copies (134 MB together, read from device memory each time),
    device ms a launch, parent and change."""
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


def same(a, b, any_hit) -> bool:
    if any_hit:
        return bool((torch.isfinite(a[0]) == torch.isfinite(b[0])).all())
    return all(bool((x.view(torch.int32) == y.view(torch.int32)).all())
               for x, y in zip(a, b))


def render_rays(box, calls, callers, order, bw, fl, smi):
    """Every version on the rays of one pass of the render: checked call by
    call, then the pass's calls timed together and by kind (the nearest-hit
    calls on bounce rays, after the camera rays' first; the shadow-ray
    calls), device ms a launch."""
    T = box[0].shape[0]
    for k, (rays, any_hit) in enumerate(calls):
        ref = kern.intersect_tris(*box, *rays, any_hit=any_hit)
        equal = {t: same(c(*box, *rays, any_hit=any_hit), ref, any_hit)
                 for t, c in callers.items()}
        assert all(equal.values()), (k, equal)
    groups = {'pass': calls, 'bounce_nearest': calls[2::2],
              'shadow_any_hit': calls[1::2]}
    for name, group in groups.items():
        bound = sum(max(bound_of(r[0].shape[0], T, a, bw, fl)[2:])
                    for r, a in group) / len(group)
        runs = []
        for tag in order:
            ms = time_ms(lambda: [callers[tag](*box, *r, any_hit=a)
                                  for r, a in group], 7, 5) / len(group)
            runs.append({'version': tag, 'ms_per_launch': ms,
                         'roofline_share': bound / ms})
        emit({'phase': 'render_rays', 'calls': name, 'launches':
              len(group), 'bound_ms_per_launch': bound, 'runs': runs,
              'nvidia_smi': smi})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True)
    ap.add_argument('--variant', action='append', default=[],
                    metavar='TAG=DIR')
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
    dev = torch.device('cuda', torch.cuda.current_device())

    def other(root, tag):
        return load_module(os.path.join(
            root, 'mitsuba_nlvrl_tpu_torch', 'ops', 'cuda',
            'intersect_cuda.py'), f'{tag}_intersect_cuda')
    mods = {'parent': other(args.parent, 'parent'), 'change': kern}
    for spec in args.variant:
        tag, root = spec.split('=', 1)
        mods[tag] = other(root, tag)
    reports, libs = {}, {}
    for tag, mod in mods.items():
        libs[tag], reports[tag] = build_report(mod.build)
    callers = {tag: mod.intersect_tris for tag, mod in mods.items()}
    emit({'phase': 'build', 'nvidia_smi': smi, 'name': name,
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'ptxas': reports})
    for tag, path in libs.items():
        emit({'phase': 'sass', 'library': tag, 'kernels': sass(
            path, tag, args.out)})

    bw, fl, _ = peaks(name)
    variants = [t for t in mods if t not in ('parent', 'change')]
    order = ['parent', 'change'] + variants + ['change', 'parent']
    cases, calls = shapes(dev)
    scan(cases['cbox_camera_512'], callers, bw, fl, smi)
    floors(cases['cbox_camera_512'], bw, smi)
    host_pieces(cases['cbox_camera_512'], smi)
    for shape, (tris, rays) in cases.items():
        N, T = rays[0].shape[0], tris[0].shape[0]
        for any_hit in (False, True):
            # any hit reads as much and writes t alone
            nbytes = N * (36 if any_hit else 48) + 36 * T
            bound = max(nbytes / bw, FLOPS_PER_PAIR * N * T / fl) * 1e3
            ref = kern.intersect_tris(*tris, *rays, any_hit=any_hit)
            emit({'phase': 'check', 'shape': shape, 'any_hit': any_hit,
                  'equal': {t: same(c(*tris, *rays, any_hit=any_hit), ref,
                                    any_hit) for t, c in callers.items()}})
            runs = []
            for tag in order:
                ms = time_ms(lambda: callers[tag](*tris, *rays,
                                                  any_hit=any_hit), 7, 50)
                runs.append({'version': tag, 'ms': ms,
                             'roofline_share': bound / ms})
            emit({'phase': 'time', 'shape': shape, 'rays': N, 'tris': T,
                  'any_hit': any_hit, 'bound_ms': bound, 'runs': runs,
                  'nvidia_smi': smi})
    render_rays(cases['cbox_camera_512'][0], calls, callers, order, bw, fl,
                smi)
    l2(cases['cbox_camera_512'], callers, smi)
    for shape, (tris, rays) in cases.items():
        host = []
        for tag in ('parent', 'change', 'change', 'parent'):
            host.append({'version': tag, 'host_ms_per_call': host_ms(
                lambda: callers[tag](*tris, *rays), 200),
                'host_ms_per_call_any_hit': host_ms(
                lambda: callers[tag](*tris, *rays, any_hit=True), 200)})
        emit({'phase': 'host', 'shape': shape, 'runs': host,
              'nvidia_smi': smi})
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

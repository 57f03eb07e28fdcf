"""Command-line renderer.

Port of ``mitsuba_nlvrl_tpu/__main__.py``:

    python -m mitsuba_nlvrl_tpu_torch scene.xml [-o out.exr] [-s SPP]
        [-D key=value ...] [--integrator NAME] [--res WxH] [--seed N]
        [--png preview.png] [--timeout SEC] [-v] [--device cuda|cpu]

The scene renders on the CUDA device unless ``--device`` names another;
without a card and without ``--device cpu`` the command exits non-zero,
it never falls back to the CPU. SIGHUP writes the partial film to the
output; the first SIGINT stops after the current pass and writes the
partial film, the second aborts.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='mitsuba_nlvrl_tpu_torch',
        description='Render a Mitsuba XML scene with the PyTorch/CUDA port '
                    'of mitsuba_nlvrl_tpu.')
    ap.add_argument('scene', help='Mitsuba XML scene file')
    ap.add_argument('-o', '--output', default=None,
                    help='output EXR path (default: scene name .exr)')
    ap.add_argument('-s', '--spp', type=int, default=None,
                    help='override samples per pixel')
    ap.add_argument('-D', dest='defines', action='append', default=[],
                    metavar='key=value',
                    help='scene parameter substitution ($key in XML)')
    ap.add_argument('--integrator', default=None,
                    help='override integrator type')
    ap.add_argument('--res', default=None, metavar='WxH',
                    help='override film resolution')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--spectral', action='store_true',
                    help='hero-wavelength spectral transport (the path '
                         'integrator and the stokes/moment/aov wrappers)')
    ap.add_argument('--png', default=None, help='also write a tonemapped PNG')
    ap.add_argument('--timeout', type=float, default=None, metavar='SEC',
                    help='stop rendering after SEC seconds and develop the '
                         'partial film')
    ap.add_argument('--device', default=None,
                    help="render device (default: cuda; the CPU only when "
                         "named, e.g. --device cpu)")
    ap.add_argument('-v', '--verbose', action='store_true')
    args = ap.parse_args(argv)

    params = {}
    for d in args.defines:
        k, _, v = d.partition('=')
        params[k] = v

    from .core import counters
    from .scene.builder import build_scene, resolve_device
    from .scene.xml import load_file
    from .render import preprocess, render
    from .utils.io import host_array, write_exr, write_png

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (--device cpu)", file=sys.stderr)
        return 2

    t0 = time.time()
    desc = load_file(args.scene, params)
    if args.integrator:
        desc.setdefault('integrator', {})['type'] = args.integrator
    if args.res:
        w, _, h = args.res.partition('x')
        desc['sensor']['film']['width'] = int(w)
        desc['sensor']['film']['height'] = int(h)
    if args.spectral:
        desc['spectral'] = True
    scene, meta = build_scene(desc, device=device)
    print(f'[load] {args.scene}: {meta.n_tris} tris, {meta.n_emitters} '
          f'emitters, {meta.n_media} media, integrator={meta.integrator}, '
          f'device={device} ({time.time() - t0:.2f}s)', flush=True)

    out = args.output or os.path.splitext(args.scene)[0] + '.exr'

    # signal-driven control: SIGHUP develops the partial film to the
    # output mid-render; the first SIGINT asks for a graceful stop (partial
    # develop and write), a second aborts
    flags = {'hup': False, 'int': 0}

    def _on_hup(sig, frm):
        flags['hup'] = True

    def _on_int(sig, frm):
        flags['int'] += 1
        if flags['int'] > 1:
            raise KeyboardInterrupt
        print('[signal] stop requested: finishing the current pass, the '
              'partial film will be written (^C again to abort)', flush=True)

    if hasattr(signal, 'SIGHUP'):
        signal.signal(signal.SIGHUP, _on_hup)
    signal.signal(signal.SIGINT, _on_int)

    def on_pass(p, develop):
        if flags['hup']:
            flags['hup'] = False
            write_exr(out, develop())
            print(f'[signal] SIGHUP: partial film ({p + 1} passes) '
                  f'written to {out}', flush=True)

    if args.verbose:
        counters.reset()
    t0 = time.time()
    info, ray_stats = {}, []
    # two-pass integrators: run the preprocess here so that its map
    # statistics can be printed
    aux = preprocess(scene, meta, seed=args.seed) if args.verbose else None
    img = host_array(render(scene, meta, seed=args.seed, spp=args.spp,
                            verbose=args.verbose, timeout=args.timeout,
                            should_stop=lambda: flags['int'] > 0,
                            on_pass=on_pass, info=info, aux=aux,
                            ray_stats=ray_stats))
    wall = time.time() - t0
    spp = args.spp or meta.spp
    tag = ' (PARTIAL)' if info.get('stopped_early') else ''
    print(f'[render] {meta.film.width}x{meta.film.height} '
          f'@ {info.get("passes_done", spp)}/{spp} spp{tag}: '
          f'{wall:.2f}s (mean {img.mean():.4f})', flush=True)

    if args.verbose:
        # the measured rays and what the render ran on, as one JSON object
        rays = float(sum(float(r) for r in ray_stats))
        print('[stats] ' + json.dumps(dict(
            rays=rays, render_s=wall, mrays_per_s=rays / wall / 1e6,
            **counters.read())), flush=True)
        if aux is not None:
            from .integrators.lighttrace import log_map_stats
            log_map_stats(aux)

    write_exr(out, img)
    print(f'[write] {out}')
    if args.png:
        write_png(args.png, img)
        print(f'[write] {args.png}')
    return 0


if __name__ == '__main__':
    sys.exit(main())

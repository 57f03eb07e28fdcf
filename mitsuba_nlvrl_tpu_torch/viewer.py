"""EXR viewer: a local web app in the place of a viewer window.

Port of ``mitsuba_nlvrl_tpu/viewer.py`` over the port's own EXR and PNG
codecs (``utils/io.py``). ``python -m mitsuba_nlvrl_tpu_torch.viewer
render.exr [more.exr ...]`` serves a tab a file, a layer selector a
channel group (the prefix before a channel's last '.'), f-stop exposure,
sRGB, linear and false-colour tonemapping, and a pixel inspector that
reports the raw float values. The standard library's HTTP server only.
"""
from __future__ import annotations

import io
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np


def _layers(names):
    """Group channel names into display layers by the prefix before the
    final '.'; bare R/G/B/A/Y/W become the root layer 'rgb'."""
    groups = {}
    for i, n in enumerate(names):
        prefix, _, ch = n.rpartition('.')
        groups.setdefault(prefix or 'rgb', []).append((ch or n, i))
    return groups


def _compose(img, names, layer):
    """(H, W, C) EXR channels -> (H, W, 3) float RGB for one layer."""
    chans = dict(_layers(names)[layer])
    H, W = img.shape[:2]

    def get(*keys):
        for k in keys:
            if k in chans:
                return img[:, :, chans[k]]
        return None

    r, g, b = get('R'), get('G'), get('B')
    if r is not None and g is not None and b is not None:
        return np.stack([r, g, b], -1)
    y = get('Y', 'W')
    if y is not None:
        return np.repeat(y[:, :, None], 3, 2)
    first = img[:, :, next(iter(chans.values()))]
    return np.repeat(first[:, :, None], 3, 2)


def _falsecolor(x):
    """Viridis-like 5-stop ramp over normalized luminance."""
    stops = np.array([[0.267, 0.005, 0.329], [0.229, 0.322, 0.546],
                      [0.128, 0.567, 0.551], [0.369, 0.789, 0.383],
                      [0.993, 0.906, 0.144]], np.float32)
    t = np.clip(x, 0.0, 1.0) * (len(stops) - 1)
    i = np.minimum(t.astype(np.int32), len(stops) - 2)
    f = (t - i)[..., None]
    return stops[i] * (1 - f) + stops[i + 1] * f


def tonemap(rgb, exposure=0.0, mode='srgb'):
    """Float RGB -> uint8 preview (exposure in f-stops)."""
    x = np.asarray(rgb, np.float32) * (2.0 ** exposure)
    if mode == 'false':
        lum = x @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        x = _falsecolor(lum / max(float(lum.max()), 1e-8))
        return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)
    x = np.clip(x, 0.0, 1.0)
    if mode == 'srgb':
        x = np.where(x <= 0.0031308, 12.92 * x,
                     1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
    return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>mitsuba_nlvrl_tpu_torch viewer</title><style>
body{margin:0;background:#222;color:#ddd;font:13px sans-serif}
#bar{padding:6px 10px;background:#333;display:flex;gap:14px;align-items:center;flex-wrap:wrap}
select,input{background:#444;color:#ddd;border:1px solid #555}
#wrap{overflow:auto;height:calc(100vh - 40px)}
img{image-rendering:pixelated;transform-origin:0 0}
#px{font-family:monospace}</style></head><body>
<div id="bar">
 <select id="file"></select> <select id="layer"></select>
 <label>exposure <input id="exp" type="range" min="-10" max="10" step="0.5" value="0">
 <span id="expv">0</span></label>
 <select id="tm"><option value="srgb">sRGB</option><option value="linear">linear</option>
 <option value="false">false color</option></select>
 <label>zoom <input id="zoom" type="range" min="0" max="5" step="1" value="2"></label>
 <span id="px"></span></div>
<div id="wrap"><img id="im"></div><script>
const q=id=>document.getElementById(id);
let meta=null;
async function init(){meta=await (await fetch('meta')).json();
 q('file').innerHTML=meta.files.map((f,i)=>`<option value="${i}">${f.name}</option>`).join('');
 fileChanged();}
function fileChanged(){const f=meta.files[q('file').value];
 q('layer').innerHTML=f.layers.map(l=>`<option>${l}</option>`).join('');refresh();}
function refresh(){q('expv').textContent=q('exp').value;
 q('im').src=`img?file=${q('file').value}&layer=${encodeURIComponent(q('layer').value)}`
  +`&exposure=${q('exp').value}&tm=${q('tm').value}&_=${Date.now()}`;
 q('im').style.transform=`scale(${2**(q('zoom').value-2)})`;}
q('file').onchange=fileChanged;
for(const id of ['layer','exp','tm','zoom']) q(id).oninput=refresh;
q('im').onmousemove=async e=>{const r=e.target.getBoundingClientRect();
 const s=2**(q('zoom').value-2);
 const x=Math.floor((e.clientX-r.left)/s), y=Math.floor((e.clientY-r.top)/s);
 const v=await (await fetch(`value?file=${q('file').value}`
  +`&layer=${encodeURIComponent(q('layer').value)}&x=${x}&y=${y}`)).json();
 q('px').textContent=`(${x},${y}) ${v.rgb.map(c=>c.toPrecision(5)).join(' ')}`;};
init();</script></body></html>"""


class ViewerState:
    def __init__(self, paths):
        from .utils.io import read_exr
        self.files = []
        for p in paths:
            img, names = read_exr(p)
            self.files.append({'path': p, 'name': os.path.basename(p),
                               'img': img, 'names': names,
                               'layers': sorted(_layers(names))})


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):          # a quiet server
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from .utils.io import write_png
            u = urlparse(self.path)
            qs = {k: v[0] for k, v in parse_qs(u.query).items()}
            route = u.path.strip('/')
            try:
                if route == '':
                    return self._send(200, 'text/html',
                                      _PAGE.encode())
                f = state.files[int(qs.get('file', 0))]
                layer = qs.get('layer', f['layers'][0])
                rgb = _compose(f['img'], f['names'], layer)
                if route == 'meta':
                    body = json.dumps({'files': [
                        {'name': x['name'], 'layers': x['layers'],
                         'w': x['img'].shape[1], 'h': x['img'].shape[0]}
                        for x in state.files]}).encode()
                    return self._send(200, 'application/json', body)
                if route == 'img':
                    u8 = tonemap(rgb, float(qs.get('exposure', 0.0)),
                                 qs.get('tm', 'srgb'))
                    buf = io.BytesIO()
                    write_png(buf, u8)
                    return self._send(200, 'image/png', buf.getvalue())
                if route == 'value':
                    y = min(max(int(qs.get('y', 0)), 0), rgb.shape[0] - 1)
                    x = min(max(int(qs.get('x', 0)), 0), rgb.shape[1] - 1)
                    return self._send(200, 'application/json', json.dumps(
                        {'rgb': [float(v) for v in rgb[y, x]]}).encode())
                return self._send(404, 'text/plain', b'not found')
            except Exception as e:  # the client sees the error
                return self._send(500, 'text/plain', str(e).encode())

    return Handler


def serve(paths, port=0, open_browser=False):
    """Start the viewer server; returns (server, thread). port=0 picks a
    free port (server.server_address[1])."""
    state = ViewerState(paths)
    srv = ThreadingHTTPServer(('127.0.0.1', port), _make_handler(state))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog='mitsuba_nlvrl_tpu_torch.viewer',
        description='EXR viewer: tabs, layers, exposure, false color, '
                    'pixel inspector, served locally.')
    ap.add_argument('files', nargs='+', help='EXR files to view')
    ap.add_argument('--port', type=int, default=8642)
    args = ap.parse_args(argv)
    srv, th = serve(args.files, args.port)
    host, port = srv.server_address
    print(f'viewing {len(args.files)} file(s) at http://{host}:{port}/ '
          f'(ctrl-c to quit)')
    try:
        th.join()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == '__main__':
    main()

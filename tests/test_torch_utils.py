"""Slice 10's small core pieces and single-card utilities against the
reference's: ``AnimatedTransform``, ``BBox`` and the slab test, the local
frame's trigonometry, ``PositionSample``, checkpoint and resume, the
logger, the profiler and the EXR viewer.

Tolerances: the animated transform's matrices (numpy float64, rounded to
float32 by ``Transform.from_matrix`` in both packages) equal in bits; the
slab test and the frame helpers 1e-6 (float32, op by op); a resumed
render equal in bits to the uninterrupted one."""
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.core import frame as jfr
from mitsuba_nlvrl_tpu.core import ray as jray
from mitsuba_nlvrl_tpu.core import records as jrec
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu_torch.core import frame as pfr
from mitsuba_nlvrl_tpu_torch.core import ray as pray
from mitsuba_nlvrl_tpu_torch.core import records as prec
from mitsuba_nlvrl_tpu_torch.core import transform as ptr
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes
from mitsuba_nlvrl_tpu_torch.utils import checkpoint, logger, profiler
from mitsuba_nlvrl_tpu_torch.utils.io import write_exr

torch.set_num_threads(1)   # one intra-op thread a test worker


def _keyframes(tr):
    return [(0.0, tr.translate((1, 2, 3)) @ tr.rotate((0, 1, 0), 10)
             @ tr.scale((1, 2, 1))),
            (1.0, tr.translate((-1, 0, 2)) @ tr.rotate((1, 1, 0), 120)
             @ tr.scale(0.5)),
            (2.5, tr.rotate((0, 0, 1), -170) @ tr.scale((1, 1, 3)))]


def test_animated_transform_matches_reference():
    aj, ap = jtr.AnimatedTransform(), ptr.AnimatedTransform()
    assert np.array_equal(np.asarray(ap.eval(0.3).m),
                          np.eye(4, dtype=np.float32))
    for (t, a), (_, b) in zip(_keyframes(jtr), _keyframes(ptr)):
        aj.append(t, a)
        ap.append(t, b)
    for t in (-1.0, 0.0, 0.25, 0.5, 1.0, 1.7, 2.5, 9.0):
        mj, mp = np.asarray(aj.eval(t).m), np.asarray(ap.eval(t).m)
        assert mp.tobytes() == mj.tobytes(), t
    # a keyframe comes back, its rotation proper
    np.testing.assert_allclose(np.asarray(ap.eval(1.0).m),
                               np.asarray(_keyframes(ptr)[1][1].m),
                               atol=1e-5)
    assert np.linalg.det(np.asarray(ap.eval(0.5).m)[:3, :3]) > 0


def test_bbox_and_slab_test():
    rng = np.random.default_rng(0)
    N = 2000
    lo = rng.uniform(-1, 0, (N, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1, (N, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[::2] = 0.5 * (lo + hi)[::2] - o[::2]   # half aimed at their box
    d[::7, 0] = 0.0                       # axis-parallel rays
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    T = torch.from_numpy
    bj, bp = jray.BBox(jnp.asarray(lo), jnp.asarray(hi)), \
        pray.BBox(T(lo), T(hi))
    rj = jray.Ray.make(jnp.asarray(o), jnp.asarray(d))
    rp = pray.Ray.make(T(o), T(d))
    for a, b in zip(jray.ray_bbox_intersect(rj, bj),
                    pray.ray_bbox_intersect(rp, bp)):
        a, b = np.asarray(a), b.numpy()
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, atol=1e-6)
    hit = pray.ray_bbox_intersect(rp, bp)[0].numpy()
    assert 0.2 < hit.mean() < 0.8
    for f in ('center', 'extents', 'surface_area'):
        np.testing.assert_allclose(getattr(bp, f)().numpy(),
                                   np.asarray(getattr(bj, f)()), rtol=1e-6)
    p = o * 0.3
    assert np.array_equal(bp.contains(T(p)).numpy(),
                          np.asarray(bj.contains(jnp.asarray(p))))
    e = bp.expand(pray.BBox(T(lo * 2), T(hi * 0.5)))
    ej = bj.expand(jray.BBox(jnp.asarray(lo * 2), jnp.asarray(hi * 0.5)))
    assert np.array_equal(e.lo.numpy(), np.asarray(ej.lo))


@pytest.mark.parametrize('name', ['cos_theta', 'cos_theta_2', 'sin_theta_2',
                                  'sin_theta', 'tan_theta', 'tan_theta_2',
                                  'sin_phi', 'cos_phi'])
def test_frame_helpers(name):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(1000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0, 0]]
    a = np.asarray(getattr(jfr, name)(jnp.asarray(v)))
    b = getattr(pfr, name)(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_position_sample_fields():
    assert prec.PositionSample._fields == jrec.PositionSample._fields


def test_checkpoint_resume_identical(tmp_path):
    """A render stopped after 2 passes and resumed to 4 equals the
    uninterrupted render in bits."""
    scene, meta = P.build_scene(pscenes.cornell_box(spp=4, res=12),
                                device='cpu')
    full = P.render(scene, meta, spp=4, seed=5).numpy()
    ck = str(tmp_path / 'ck.pt')
    checkpoint.render_with_checkpoints(scene, meta, seed=5, spp=2,
                                       ckpt_path=ck, ckpt_every=2)
    st = checkpoint.load_render_state(ck)
    assert st['passes_done'] == 2 and st['seed'] == 5
    img = checkpoint.render_with_checkpoints(scene, meta, seed=5, spp=4,
                                             ckpt_path=ck, ckpt_every=2)
    assert np.array_equal(img.numpy(), full)


def test_checkpoint_carries_maps_and_extra(tmp_path):
    """A two-pass integrator's maps and extra parameters survive the
    round trip; the resumed ``vrl`` render equals the uninterrupted one."""
    d = pscenes.cbox_nlvrl(8, 4, spp=2, target_vrls=64, light_depth_cap=4,
                           max_nl_bends=4, gather_points_cap=4,
                           max_cam_iters=3, global_photons=1024)
    scene, meta = P.build_scene(d, device='cpu')
    full = P.render(scene, meta, seed=1).numpy()
    ck = str(tmp_path / 'vrl.pt')
    checkpoint.render_with_checkpoints(scene, meta, seed=1, spp=1,
                                       ckpt_path=ck, ckpt_every=1)
    img = checkpoint.render_with_checkpoints(scene, meta, seed=1, spp=2,
                                             ckpt_path=ck)
    assert np.array_equal(img.numpy(), full)
    checkpoint.save_render_state(ck, torch.zeros(2, 2, 4), 3, 7,
                                 extra={'bsdfs.params': torch.ones(2)})
    st = checkpoint.load_render_state(ck)
    assert st['passes_done'] == 3 and 'aux' not in st
    assert torch.equal(st['extra']['bsdfs.params'], torch.ones(2))


def test_logger(capsys):
    old = logger.log_level()
    try:
        logger.set_log_level(logger.Warn)
        logger.Log(logger.Info, 'hidden %d', 1)
        logger.Log(logger.Warn, 'shown %s', 'w')
        with pytest.raises(RuntimeError, match='boom'):
            logger.Log(logger.Error, 'boom')
    finally:
        logger.set_log_level(old)
    out = capsys.readouterr()
    assert 'hidden' not in out.out + out.err
    assert 'WARN  shown w' in out.err


def test_profiler(tmp_path):
    scene, meta = P.build_scene(pscenes.cornell_box(spp=1, res=8),
                                device='cpu')
    with profiler.trace(str(tmp_path / 'tr')) as prof:
        P.render(scene, meta, seed=0)
    assert os.path.getsize(tmp_path / 'tr' / 'trace.json') > 0
    assert len(prof.key_averages()) > 5
    t = profiler.Timer()
    assert 0.0 <= t.value() < 60.0 and t.time_string().endswith('ms')
    c = profiler.Counters()
    c.add('rays', torch.tensor(3.0))
    c.add('rays', 4)
    c.add('maps', 1.5)
    assert c.report() == {'rays': 7.0, 'maps': 1.5}
    lines = []
    c.log(lines.append)
    assert lines == ['  [counter] maps: 1.5', '  [counter] rays: 7']


def _get(port, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/{path}',
                                timeout=10) as r:
        return r.status, r.headers.get('Content-Type'), r.read()


def test_viewer_endpoints(tmp_path):
    from mitsuba_nlvrl_tpu import viewer as jviewer
    from mitsuba_nlvrl_tpu_torch import viewer
    img = np.zeros((6, 8, 3), np.float32)
    img[:, :, 0] = np.linspace(0, 4, 8)[None, :]
    img[2, 3] = [1.25, 2.5, 0.5]
    path = str(tmp_path / 'view.exr')
    write_exr(path, img)
    srv, _ = viewer.serve([path])
    port = srv.server_address[1]
    try:
        st, ct, body = _get(port, '')
        assert st == 200 and 'html' in ct and b'exposure' in body
        meta = json.loads(_get(port, 'meta')[2])
        assert meta['files'][0]['w'] == 8 and meta['files'][0]['h'] == 6
        assert meta['files'][0]['layers'] == ['rgb']
        st, ct, body = _get(port, 'img?file=0&exposure=0&tm=srgb')
        assert st == 200 and ct == 'image/png' and body.startswith(
            b'\x89PNG')
        value = json.loads(_get(port, 'value?file=0&x=3&y=2')[2])['rgb']
        np.testing.assert_allclose(value, [1.25, 2.5, 0.5], atol=1e-6)
    finally:
        srv.shutdown()
    names = ['R', 'G', 'B', 'stokes.S1.R', 'stokes.S1.G', 'stokes.S1.B',
             'depth.Y']
    assert viewer._layers(names) == jviewer._layers(names)
    for mode in ('srgb', 'linear', 'false'):
        assert np.array_equal(viewer.tonemap(img, 1.0, mode),
                              jviewer.tonemap(img, 1.0, mode)), mode

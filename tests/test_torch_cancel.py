"""Cooperative cancellation, timeout and partial develop on the port:
``tests/test_cancel.py`` run on the port's ``render`` and CLI. The weight
channel's develop normalises a partial accumulation at any pass count."""
import os
import subprocess
import sys

import numpy as np
import torch

import mitsuba_nlvrl_tpu_torch as P

torch.set_num_threads(1)   # one intra-op thread a test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(spp=32):
    return P.build_scene({
        'shapes': [{'type': 'rectangle',
                    'bsdf': {'type': 'diffuse', 'reflectance': 0.7}}],
        'emitters': [{'type': 'constant', 'radiance': 1.0}],
        'sensor': {'type': 'perspective',
                   'film': {'width': 8, 'height': 8},
                   'sampler': {'type': 'independent', 'sample_count': spp}},
        'integrator': {'type': 'direct'},
    }, device='cpu')


def test_should_stop_partial_develop():
    scene, meta = _scene()
    calls = {'n': 0}

    def stop_after_3():
        calls['n'] += 1
        return calls['n'] >= 3

    info = {}
    img = P.render(scene, meta, spp=32, seed=1, should_stop=stop_after_3,
                   info=info).numpy()
    assert info['stopped_early']
    assert info['passes_done'] == 3
    # the partial image is normalised, not 3/32 darker
    full = P.render(scene, meta, spp=32, seed=1).numpy()
    np.testing.assert_allclose(img.mean(), full.mean(), rtol=0.05)


def test_timeout_zero_stops_after_first_pass():
    scene, meta = _scene()
    info = {}
    img = P.render(scene, meta, spp=16, seed=2, timeout=0.0,
                   info=info).numpy()
    assert info['passes_done'] == 1 and info['stopped_early']
    assert np.isfinite(img).all() and img.max() > 0


def test_on_pass_callback_develops():
    scene, meta = _scene()
    partials = []

    def on_pass(p, develop):
        if p == 1:
            partials.append(develop().numpy())

    full = P.render(scene, meta, spp=4, seed=3, on_pass=on_pass).numpy()
    assert len(partials) == 1
    np.testing.assert_allclose(partials[0].mean(), full.mean(), rtol=0.1)


def test_cli_timeout(tmp_path):
    # end to end: the CLI stops at the timeout and still writes the film
    xml = tmp_path / 'scene.xml'
    xml.write_text("""<scene version="2.0.0">
      <integrator type="direct"/>
      <sensor type="perspective">
        <film type="hdrfilm">
          <integer name="width" value="8"/>
          <integer name="height" value="8"/>
        </film>
        <sampler type="independent">
          <integer name="sample_count" value="64"/>
        </sampler>
      </sensor>
      <shape type="rectangle"/>
      <emitter type="constant"/>
    </scene>""")
    out = tmp_path / 'out.exr'
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, '-m', 'mitsuba_nlvrl_tpu_torch', str(xml),
         '-o', str(out), '--timeout', '0', '--device', 'cpu'],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'PARTIAL' in r.stdout
    assert out.exists()

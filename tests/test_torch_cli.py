"""The port's command line (``python -m mitsuba_nlvrl_tpu_torch``), run in
a subprocess with ``--device cpu``: its EXR is the in-process render bit
for bit, ``-D`` and ``--res`` apply, ``--timeout 0`` writes the partial
film, and without ``--device`` on a host without a card it exits
non-zero."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import __main__ as cli
from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes
from mitsuba_nlvrl_tpu_torch.utils.io import read_exr

torch.set_num_threads(1)   # one intra-op thread a test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, '-m', 'mitsuba_nlvrl_tpu_torch', *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def _rgb(path):
    img, names = read_exr(path)
    return img[..., [names.index(c) for c in 'RGB']]


@pytest.fixture(scope='module')
def scene_files(tmp_path_factory):
    """cbox_xml at 16x16 with its sample count and width as $params, and
    cbox_mesh at subdivision 3."""
    d = tmp_path_factory.mktemp('cli')
    path = pscenes.cbox_xml(str(d), spp=2, res=16)
    text = open(path).read()
    text = text.replace('<scene version="2.0.0">',
                        '<scene version="2.0.0">\n'
                        '    <default name="spp" value="3"/>\n'
                        '    <default name="w" value="16"/>')
    text = text.replace('name="sample_count" value="2"',
                        'name="sample_count" value="$spp"')
    text = text.replace('name="width" value="16"', 'name="width" value="$w"')
    with open(path, 'w') as f:
        f.write(text)
    mesh = pscenes.cbox_mesh(str(d), subdiv=3, spp=1, res=8)
    return path, mesh, d


def test_cli_exr_is_the_in_process_render(scene_files):
    path, _, d = scene_files
    out = str(d / 'cbox.exr')
    res = run_cli(path, '-o', out, '--device', 'cpu', '--seed', '3',
                  '-D', 'spp=2', '-D', 'w=12', '--png', str(d / 'c.png'))
    assert res.returncode == 0, res.stderr
    assert '[write]' in res.stdout and 'PARTIAL' not in res.stdout
    desc = load_file(path, {'spp': '2', 'w': '12'})
    scene, meta = P.build_scene(desc, device='cpu')
    assert (meta.film.width, meta.spp) == (12, 2)
    ref = P.render(scene, meta, seed=3).numpy()
    got = _rgb(out)
    assert got.shape == (16, 12, 3) and got.tobytes() == ref.tobytes()
    assert (d / 'c.png').read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'


def test_cli_res_spp_and_timeout(scene_files):
    """--res and -s override the file; --timeout 0 stops after the first
    pass and still writes its film."""
    path, _, d = scene_files
    out = str(d / 'partial.exr')
    res = run_cli(path, '-o', out, '--device', 'cpu', '--res', '10x6',
                  '-s', '4', '--timeout', '0')
    assert res.returncode == 0, res.stderr
    assert 'PARTIAL' in res.stdout and '@ 1/4 spp' in res.stdout
    desc = load_file(path)
    desc['sensor']['film'].update(width=10, height=6)
    scene, meta = P.build_scene(desc, device='cpu')
    ref = P.render(scene, meta, seed=0, spp=1).numpy()
    assert _rgb(out).tobytes() == ref.tobytes()


def test_cli_renders_the_mesh_scene(scene_files, capsys):
    """cbox_mesh through the CLI's main (in this process: the subprocess
    runs above cover ``python -m``): the BVH path, the verbose report."""
    _, mesh, d = scene_files
    out = str(d / 'mesh.exr')
    assert cli.main([mesh, '-o', out, '--device', 'cpu', '-v']) == 0
    stdout = capsys.readouterr().out
    assert '1292 tris' in stdout and 'pass 1/1' in stdout
    line = [x for x in stdout.splitlines() if x.startswith('[stats] ')]
    stats = json.loads(line[0][len('[stats] '):])
    # every intersection went through the BVH, none through the kernel
    assert stats['bvh_calls'] > 0 and stats['kernel_launches'] == 0
    assert stats['bvh_lanes_cut'] == 0 and stats['rays'] > 64
    img = _rgb(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01


def test_cli_without_a_card_exits_non_zero(scene_files, monkeypatch,
                                           capsys):
    """Without --device the CLI wants the card; on a host without one it
    exits non-zero with the message of resolve_device and renders
    nothing (the subprocess on this host, and main() with no card)."""
    path, _, d = scene_files
    if not torch.cuda.is_available():
        out = str(d / 'none.exr')
        res = run_cli(path, '-o', out)
        assert res.returncode != 0 and "device='cpu'" in res.stderr
        assert not os.path.exists(out)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert cli.main([path, '-o', str(d / 'none2.exr')]) != 0
    assert "device='cpu'" in capsys.readouterr().err
    assert not os.path.exists(d / 'none2.exr')
    # spectral transport outside ``path`` renders the reference's RGB
    # transport (tests/test_torch_spectral.py holds the images)
    out = str(d / 'spectral_volpath.exr')
    assert cli.main([path, '--spectral', '--integrator', 'volpath',
                     '--device', 'cpu', '-o', out]) == 0
    assert np.isfinite(_rgb(out)).all()


def test_mnt_double_renders_float64(scene_files, monkeypatch):
    """MNT_DOUBLE=1 turns the double variant on, as in the reference's
    build_scene: the port's build_scene makes every float table float64,
    and the CLI renders in float64 an EXR equal to the in-process float64
    render (written as float32). MNT_DOUBLE=0 builds float32."""
    path, _, d = scene_files
    monkeypatch.setenv('MNT_DOUBLE', '1')
    s, m = P.build_scene(load_file(path), device='cpu')
    assert s.dtype == torch.float64 and s.bsdfs.params.dtype == torch.float64
    img = P.render(s, m, seed=0)
    assert img.dtype == torch.float64
    out = str(d / 'double.exr')
    assert cli.main([path, '-o', out, '--device', 'cpu']) == 0
    np.testing.assert_array_equal(_rgb(out), img.numpy().astype(np.float32))
    monkeypatch.setenv('MNT_DOUBLE', '0')
    s, _ = P.build_scene(pscenes.cornell_box(spp=1, res=8), device='cpu')
    assert s.dtype == torch.float32


def test_cli_spectral_exr_is_the_in_process_render(tmp_path, monkeypatch):
    """``--spectral`` on ``cbox_spectral`` (the named conductor's curves
    from ``MNT_IOR_DIR``): the EXR equals the in-process spectral render
    in bits."""
    path = pscenes.cbox_spectral(str(tmp_path), spp=1, res=8, max_depth=4)
    monkeypatch.setenv('MNT_IOR_DIR', str(tmp_path))
    out = str(tmp_path / 'spectral.exr')
    res = run_cli(path, '-o', out, '--device', 'cpu', '--spectral')
    assert res.returncode == 0, res.stderr
    desc = load_file(path)
    desc['spectral'] = True
    s, m = P.build_scene(desc, device='cpu')
    assert m.spectral and m.has_conductor_spd
    img = P.render(s, m, seed=0).numpy()
    assert np.array_equal(_rgb(out), img)
    assert img.mean() > 0.01

"""The port stands alone: it never imports JAX, the JAX package or PIL,
and its entry points never drop to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # one intra-op thread a test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'mitsuba_nlvrl_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'mitsuba_nlvrl_tpu', 'PIL')


def _forbidden(module: str) -> bool:
    """Whole dotted names only: 'mitsuba_nlvrl_tpu_torch' is allowed."""
    return any(module == f or module.startswith(f + '.') for f in FORBIDDEN)


def test_name_guard_matches_whole_module_names():
    assert _forbidden('jax') and _forbidden('jax.numpy')
    assert _forbidden('mitsuba_nlvrl_tpu')
    assert _forbidden('mitsuba_nlvrl_tpu.ops.intersect')
    assert not _forbidden('mitsuba_nlvrl_tpu_torch')
    assert not _forbidden('mitsuba_nlvrl_tpu_torch.core.rng')
    assert not _forbidden('jaxtyping_like')
    assert _forbidden('PIL') and _forbidden('PIL.Image')


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')
    scripts = os.path.join(ROOT, 'scripts')
    for f in sorted(os.listdir(scripts)):
        if f.startswith('port_') and f.endswith('.py'):
            yield os.path.join(scripts, f)


def test_no_forbidden_import_in_sources():
    bad = []
    n = 0
    for path in _sources():
        n += 1
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            elif isinstance(node, ast.Call) and \
                    getattr(node.func, 'id', None) == '__import__':
                names = [a.value for a in node.args[:1]
                         if isinstance(a, ast.Constant)]
            bad += [(path, m) for m in names if _forbidden(m)]
    assert n > 30, n
    names = {os.path.basename(p) for p in _sources()}
    for f in ('nonlinear.py', 'hashgrid.py', 'lighttrace.py', 'vrl.py',
              'photon_est.py', 'photonmapper.py', 'nlvrl_probe.py',
              'port_profile_nlvrl.py', '__main__.py', 'xml.py', 'mesh_io.py',
              'bvh.py', 'io.py', 'exr_piz.py', 'ior_data.py',
              'spectrum.py', 'cie_data.py', 'microfacet.py', 'warp.py',
              'distr.py', 'distr2d.py', 'direct.py', 'depth.py',
              'spectral.py', 'mueller.py', 'polarized.py',
              'path_spectral.py', 'path_polarized.py',
              'path_spectral_polarized.py', 'aov.py', 'regen.py',
              'autodiff.py', 'render_dist.py', 'remat.py', 'measured.py',
              'measured_pol.py', 'chi2.py', 'checkpoint.py', 'logger.py',
              'profiler.py', 'viewer.py'):
        assert f in names, f
    texture = os.path.join(PORT, 'texture', '__init__.py')
    assert texture in set(_sources())
    assert not bad, bad


def test_cpu_render_loads_no_jax():
    code = (
        "import sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import "
        "cbox_materials\n"
        "s, m = P.build_scene(cornell_box(spp=1, res=8), device='cpu')\n"
        "sm, mm = P.build_scene(cbox_materials(8, 8, 1), device='cpu')\n"
        "assert bool(P.render(sm, mm, seed=0).isfinite().all())\n"
        "img = P.render(s, m, seed=0, spp=1)\n"
        "assert img.shape == (8, 8, 3) and bool(img.isfinite().all())\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert 'mitsuba_nlvrl_tpu_torch.ops.cuda.intersect_cuda' in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_volumetric_render_loads_no_jax():
    """The volumetric slice (phase, medium, volpath, the .vol reader)
    renders on the CPU without JAX or the reference package loaded."""
    code = (
        "import sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch.scene import vol_io\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box\n"
        "d = hetvol_box(8, 6, spp=1, grid_res=16, seed=0, scale=20.0)\n"
        "s, m = P.build_scene(d, device='cpu')\n"
        "img = P.render(s, m, seed=0, spp=1)\n"
        "assert img.shape == (6, 8, 3) and bool(img.isfinite().all())\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('phase', 'medium', 'integrators.volpath', 'scene.vol_io'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_nlvrl_render_loads_no_jax():
    """The NLVRL slice (nonlinear medium, light tracing, hash grids, the
    vrl and photonmapper integrators) renders on the CPU without JAX or
    the reference package loaded."""
    code = (
        "import sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl\n"
        "for integ in ('vrl', 'photonmapper'):\n"
        "    d = cbox_nlvrl(8, 4, spp=1, target_vrls=64, integrator=integ,\n"
        "                   light_depth_cap=4, max_nl_bends=4,\n"
        "                   gather_points_cap=4, max_cam_iters=3,\n"
        "                   global_photons=1024)\n"
        "    s, m = P.build_scene(d, device='cpu')\n"
        "    img = P.render(s, m, seed=0, spp=1)\n"
        "    assert img.shape == (4, 8, 3) and bool(img.isfinite().all())\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('medium.nonlinear', 'ops.hashgrid', 'integrators.lighttrace',
                'integrators.photon_est', 'integrators.vrl',
                'integrators.photonmapper'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_scene_file_render_loads_no_jax(tmp_path):
    """The scene-file slice (the XML and mesh loaders, the native BVH
    builder through ctypes, the traversal, the EXR writer and the CLI's
    module) renders a mesh scene on the CPU without JAX or the reference
    package loaded."""
    code = (
        "import sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "import mitsuba_nlvrl_tpu_torch.__main__\n"
        "from mitsuba_nlvrl_tpu_torch.scene.xml import load_file\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_mesh\n"
        "from mitsuba_nlvrl_tpu_torch.utils.io import write_exr\n"
        f"path = cbox_mesh({str(tmp_path)!r}, subdiv=3, spp=1, res=4)\n"
        "s, m = P.build_scene(load_file(path), device='cpu')\n"
        "assert m.has_bvh and s.bvh is not None\n"
        "img = P.render(s, m, seed=0)\n"
        f"write_exr({str(tmp_path / 'a.exr')!r}, img)\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('scene.xml', 'scene.mesh_io', 'native', 'ops.bvh',
                'utils.io', '__main__'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_textured_render_loads_no_jax(tmp_path):
    """ROADMAP item 7 (textures and the PNG reader, the wrapper BSDFs, the
    remaining lights, samplers and sensors, direct and depth, instancing)
    renders on the CPU without JAX, the reference package or PIL."""
    code = (
        "import sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch.scene.xml import load_file\n"
        "from mitsuba_nlvrl_tpu_torch.testing import scenes as S\n"
        f"d = {str(tmp_path)!r}\n"
        "s, m = P.build_scene(load_file(S.cbox_textured(d, spp=1, res=8)),\n"
        "                     device='cpu')\n"
        "assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "s, m = P.build_scene(S.env_spheres(d, 8, 8, 1), device='cpu')\n"
        "assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "for i in ('direct', 'depth'):\n"
        "    s, m = P.build_scene(S.cornell_box(spp=1, res=8,\n"
        "                         integrator={'type': i}), device='cpu')\n"
        "    assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('texture', 'core.distr2d', 'sampler', 'integrators.direct',
                'integrators.depth'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_bvh_builder_raises_with_the_compilers_message(monkeypatch,
                                                       tmp_path):
    """The BVH builder has no fallback: a failed compile raises with the
    compiler's message, so a tree never depends on a missing toolchain."""
    from mitsuba_nlvrl_tpu_torch import native
    from mitsuba_nlvrl_tpu_torch.ops import bvh
    fake = tmp_path / 'fake-cxx'
    fake.write_text('#!/bin/sh\necho "fake-cxx: cannot compile" >&2\n'
                    'exit 3\n')
    fake.chmod(0o755)
    monkeypatch.setenv('CXX', str(fake))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_fn', None)
    v = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match='fake-cxx: cannot compile'):
        bvh.build(v, v, v)
    monkeypatch.setenv('CXX', str(tmp_path / 'absent-compiler'))
    with pytest.raises(RuntimeError, match='BVH builder'):
        bvh.build(v, v, v)


def test_build_scene_without_cuda_raises(monkeypatch):
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_scene(cornell_box())
    vol = cornell_box(integrator={'type': 'volpath'},
                      medium={'type': 'homogeneous'})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_scene(vol)
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_nlvrl
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_scene(cbox_nlvrl())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.maps_from_numpy({})
    # the CLI: no card and no --device is an error, not a CPU render
    from mitsuba_nlvrl_tpu_torch import __main__ as cli
    assert cli.main([os.path.join(ROOT, 'absent.xml')]) != 0
    scene, _ = P.build_scene(cornell_box(), device='cpu')
    assert scene.device.type == 'cpu'


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """On a non-CPU tensor the wrapper launches the kernel or raises."""
    from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
    calls = []
    monkeypatch.setattr(kern, 'intersect_tris_plain',
                        lambda *a, **k: calls.append(1))
    meta = [torch.empty((4, 3), device='meta') for _ in range(5)] + \
        [torch.empty((4,), device='meta') for _ in range(2)]
    with pytest.raises(ValueError, match='no kernel'):
        kern.intersect_tris(*meta)
    assert not calls


def test_cpu_spectral_polarized_render_loads_no_jax(tmp_path):
    """Slice 8 (spectral transport with its coefficient table, the Mueller
    calculus and the polarized BSDFs, the aov, moment and stokes
    integrators, albedo grids and the regeneration scheduler) renders on
    the CPU without JAX or the reference package, and reads the port's
    own table."""
    code = (
        "import os, sys\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch.core import spectral\n"
        "from mitsuba_nlvrl_tpu_torch.testing import scenes as S\n"
        f"os.environ['MNT_IOR_DIR'] = S.write_conductor_spd("
        f"{str(tmp_path)!r})\n"
        "d = S.dress_spectral(S.cornell_box(spp=1, res=6))\n"
        "descs = [d, S.cbox_polarized(6, 1, 2),\n"
        "         S.cbox_polarized(6, 1, 3, spectral=True,\n"
        "                          conductor=S.SPECTRAL_CONDUCTOR),\n"
        "         S.cornell_box(spp=1, res=6, integrator={'type': 'aov',\n"
        "                       'aovs': 'nn:sh_normal'}),\n"
        "         S.cornell_box(spp=1, res=6,\n"
        "                       integrator={'type': 'moment'}),\n"
        "         S.cornell_box(spp=1, res=6,\n"
        "                       medium=S.albedo_grid_medium(8),\n"
        "                       integrator={'type': 'volpath'})]\n"
        "for i, desc in enumerate(descs):\n"
        "    if i == 5:\n"
        "        os.environ.update(MNT_REGEN='1', MNT_REGEN_LANES='64')\n"
        "    s, m = P.build_scene(desc, device='cpu')\n"
        "    info = {}\n"
        "    img = P.render(s, m, seed=0, info=info)\n"
        "    assert img.shape == (6, 6, 3) and bool(img.isfinite().all())\n"
        "assert info['scheduler'] == 'regen'\n"
        "assert spectral.get_lut_np().shape == (3, 32, 33, 33, 3)\n"
        "print(spectral.LUT_PATH)\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lut_path, modules = out.stdout.strip().split('\n')[-2:]
    assert lut_path == os.path.join(PORT, 'data', 'srgb_coeff.npz')
    loaded = modules.split()
    for mod in ('core.spectral', 'core.mueller', 'bsdf.polarized',
                'integrators.path_spectral', 'integrators.path_polarized',
                'integrators.path_spectral_polarized', 'integrators.aov',
                'integrators.regen'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_diff_render_loads_no_jax():
    """The autodiff slice (autodiff.py, parallel/render_dist.py, the
    checkpointed bounce loops, the scatter splat) renders and
    differentiates on the CPU without JAX or the reference package."""
    code = (
        "import sys, torch\n"
        "from mitsuba_nlvrl_tpu_torch import build_scene, autodiff as ad\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box\n"
        "from mitsuba_nlvrl_tpu_torch.testing.scenes import hetvol_box\n"
        "for d, key in ((cornell_box(spp=1, res=6), 'bsdfs.params'),\n"
        "               (hetvol_box(6, 4, spp=1, grid_res=8, scale=5.0),\n"
        "                'media.grid_sigma_t')):\n"
        "    s, m = build_scene(d, device='cpu')\n"
        "    pm = ad.traverse(s).keep([key])\n"
        "    opt = ad.Adam(pm, lr=0.01)\n"
        "    img = ad.render(s, m, params=opt.params, pmap=pm, spp=1)\n"
        "    img.mean().backward()\n"
        "    g = opt.params[key].grad\n"
        "    assert bool(g.isfinite().all()) and float(g.abs().sum()) > 0\n"
        "    opt.step()\n"
        "    assert opt.update_scene() is pm.scene\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('autodiff', 'parallel.render_dist', 'core.remat'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]


def test_cpu_slice10_loads_no_jax(tmp_path):
    """Slice 10 (the measured BSDFs read from their files, the double
    variant, a spectral request on ``volpath``, the chi-square harness,
    the warps, the core pieces and the single-card utilities) runs on the
    CPU without JAX or the reference package loaded."""
    code = (
        "import sys\n"
        "import torch\n"
        "import mitsuba_nlvrl_tpu_torch as P\n"
        "from mitsuba_nlvrl_tpu_torch import viewer\n"
        "from mitsuba_nlvrl_tpu_torch.core import warp\n"
        "from mitsuba_nlvrl_tpu_torch.core.ray import BBox, "
        "ray_bbox_intersect\n"
        "from mitsuba_nlvrl_tpu_torch.core.transform import "
        "AnimatedTransform\n"
        "from mitsuba_nlvrl_tpu_torch.core.records import PositionSample\n"
        "from mitsuba_nlvrl_tpu_torch.scene.xml import load_file\n"
        "from mitsuba_nlvrl_tpu_torch.testing import scenes as S\n"
        "from mitsuba_nlvrl_tpu_torch.testing.chi2 import ChiSquareTest, "
        "SphericalDomain\n"
        "from mitsuba_nlvrl_tpu_torch.utils import checkpoint, logger, "
        "profiler\n"
        f"d = {str(tmp_path)!r}\n"
        "s, m = P.build_scene(load_file(S.cbox_measured(d, spp=1, res=8)),\n"
        "                     device='cpu')\n"
        "assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "s, m = P.build_scene(S.cbox_measured_polarized(d, 8, 1),\n"
        "                     device='cpu')\n"
        "assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "desc = S.cornell_box(spp=1, res=8); desc['double'] = True\n"
        "s, m = P.build_scene(desc, device='cpu')\n"
        "assert P.render(s, m, seed=0).dtype == torch.float64\n"
        "desc = S.cornell_box(spp=1, res=8, integrator={'type': 'volpath'})\n"
        "desc['spectral'] = True\n"
        "s, m = P.build_scene(desc, device='cpu')\n"
        "assert bool(P.render(s, m, seed=0).isfinite().all())\n"
        "t = ChiSquareTest(SphericalDomain(), warp.square_to_cosine_hemisphere,"
        "\n                  warp.square_to_cosine_hemisphere_pdf,"
        " sample_count=20000, res=8)\n"
        "assert t.run(0.001), t.messages\n"
        "print(' '.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    for mod in ('bsdf.measured', 'bsdf.measured_pol', 'core.distr2d',
                'testing.chi2', 'utils.checkpoint', 'utils.logger',
                'utils.profiler', 'viewer'):
        assert f'mitsuba_nlvrl_tpu_torch.{mod}' in loaded, mod
    assert not [m for m in loaded if _forbidden(m)]

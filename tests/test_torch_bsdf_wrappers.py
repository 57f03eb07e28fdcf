"""The port's wrapper BSDFs (``mask``, ``blendbsdf``, ``normalmap``,
``bumpmap``) and textured BSDF parameters (alpha, specular reflectance,
diffuse reflectance, the plastic family's diffuse, mask opacity, blend
weight) against the reference's: ``eval``, ``pdf``, ``sample`` and
``eval_null_transmission`` through the type dispatch on a scene's packed
rows and texture table, on 4,096 lanes with random hit points, uv,
shading frames and directions, wi in the upper and in the lower
hemisphere; and the reference's behaviour that the port keeps.

Tolerances (as ``tests/test_torch_bsdf_rough.py`` says why): ``eval``
and ``pdf`` 1e-5 relative with an absolute floor of 1e-5 of the largest
value; sampled directions within 4e-5 where their pdf is positive, the
sampled weight and pdf 1e-4 relative; the sampled lobe kinds equal."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu.core.frame import Frame as JFrame
from mitsuba_nlvrl_tpu.core.records import SurfaceInteraction as JSI
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch.core.frame import Frame as PFrame
from mitsuba_nlvrl_tpu_torch.core.records import SurfaceInteraction as PSI
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import jax_meta_dict, scene_arrays

RTOL = 1e-5
SAMPLED_RTOL = 1e-4
DIR_ATOL = 4e-5
N = 4096


@functools.lru_cache(maxsize=None)
def _maps(directory: str) -> dict:
    return {role: f'{directory}/{name}' for role, name in
            pscenes.textured_bitmaps(directory).items()}


def _bitmap(maps, role):
    return {'type': 'bitmap', 'filename': maps[role], 'raw': True}


def _checker(c0, c1, scale=3.0):
    return {'type': 'checkerboard', 'color0': c0, 'color1': c1,
            'uscale': scale, 'vscale': scale}


def _cases(maps) -> dict:
    rough = {'type': 'roughconductor', 'alpha': 0.25,
             'eta': (0.2, 0.9, 1.1), 'k': (3.9, 2.4, 2.1)}
    return {
        'mask': {'type': 'mask', 'opacity': 0.35,
                 'bsdf': {'type': 'roughplastic', 'alpha': 0.2}},
        'mask_textured': {'type': 'mask', 'bsdf': {'type': 'diffuse'},
                          'opacity': _bitmap(maps, 'opacity')},
        'blendbsdf': {'type': 'blendbsdf', 'weight': 0.3,
                      'bsdf': [{'type': 'diffuse'}, rough]},
        'blend_textured': {'type': 'blendbsdf',
                           'weight': _bitmap(maps, 'weight'), 'bsdf': [
                               {'type': 'roughplastic', 'alpha': 0.3},
                               {'type': 'roughdielectric', 'alpha': 0.2}]},
        'normalmap': {'type': 'normalmap',
                      'normalmap': _bitmap(maps, 'normal'), 'bsdf': rough},
        'bumpmap': {'type': 'bumpmap', 'bumpmap': _bitmap(maps, 'height'),
                    'scale': 0.02, 'bsdf': {
                        'type': 'diffuse',
                        'reflectance': _checker(0.8, 0.2)}},
        'textured_alpha': dict(rough, alpha=_bitmap(maps, 'alpha')),
        'textured_specular': {'type': 'roughdielectric', 'alpha': 0.2,
                              'specular_reflectance': _checker(0.9, 0.4)},
        'textured_diffuse': {'type': 'diffuse', 'reflectance': {
            'type': 'bitmap', 'filename': maps['wall']}},
        'textured_plastic': {'type': 'plastic',
                             'diffuse_reflectance': _checker(0.7, 0.1)},
    }


def _scene(bsdf, tr=scenes.tr):
    """A rectangle carrying ``bsdf`` (a second, plain one keeps the type
    dispatch honest), built by the reference and carried into the port."""
    d = scenes.sphere_scene(spp=1, res=4)
    d['shapes'] = [{'type': 'rectangle', 'bsdf': bsdf},
                   {'type': 'rectangle', 'bsdf': {'type': 'diffuse'},
                    'to_world': tr.translate((0, 0, 3))}]
    sj, mj = J.build_scene(d)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    return sj, mj, sp, mp


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _hits(sj, sp, hemisphere, seed=0):
    """The same 4,096 hits for both packages: the first shape's row."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0, 1, 0]], [[1, 0, 0]])
    s = np.cross(n, a)
    s = (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(np.float32)
    t = np.cross(n, s).astype(np.float32)
    wi = _unit(rng, N)
    wi[:, 2] = np.abs(wi[:, 2]) * (1 if hemisphere == 'upper' else -1)
    f = {'valid': np.ones(N, bool), 't': np.ones(N, np.float32),
         'p': rng.uniform(-1, 1, (N, 3)).astype(np.float32), 'n': n,
         'uv': rng.uniform(0, 1, (N, 2)).astype(np.float32), 'wi': wi,
         'prim_index': np.zeros(N, np.int32),
         'shape_idx': np.zeros(N, np.int32),
         'bsdf_idx': np.full(N, int(np.asarray(sj.shapes.bsdf_idx)[0]),
                             np.int32),
         'emitter_idx': np.full(N, -1, np.int32),
         'int_medium': np.full(N, -1, np.int32),
         'ext_medium': np.full(N, -1, np.int32)}
    si_j = JSI(sh_frame=JFrame(*(jnp.asarray(x) for x in (s, t, n))),
               **{k: jnp.asarray(v) for k, v in f.items()})
    si_p = PSI(sh_frame=PFrame(*(torch.from_numpy(x) for x in (s, t, n))),
               **{k: torch.from_numpy(v) for k, v in f.items()})
    wo = _unit(rng, N)
    u1 = rng.uniform(0, 1, N).astype(np.float32)
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    return si_j, si_p, [(jnp.asarray(x), torch.from_numpy(x))
                        for x in (wo, u1, u2)]


def _close(got, ref, name, atol=None, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, name
    if atol is None:
        atol = rtol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


CASE_NAMES = ('mask', 'mask_textured', 'blendbsdf', 'blend_textured',
              'normalmap', 'bumpmap', 'textured_alpha', 'textured_specular',
              'textured_diffuse', 'textured_plastic')


@functools.lru_cache(maxsize=None)
def _case_scene(name, directory):
    return _scene(_cases(_maps(directory))[name])


@pytest.mark.parametrize('hemisphere', ['upper', 'lower'])
@pytest.mark.parametrize('name', CASE_NAMES)
def test_wrapper_and_textured_rows_match_reference(name, hemisphere,
                                                   tmp_path_factory):
    sj, mj, sp, mp = _case_scene(
        name, str(tmp_path_factory.getbasetemp() / 'maps'))
    si_j, si_p, ((wo_j, wo_p), (u1_j, u1_p), (u2_j, u2_p)) = \
        _hits(sj, sp, hemisphere)
    _close(pbsdf.eval(sp, mp, si_p, wo_p), jbsdf.eval(sj, mj, si_j, wo_j),
           'eval')
    _close(pbsdf.pdf(sp, mp, si_p, wo_p), jbsdf.pdf(sj, mj, si_j, wo_j),
           'pdf')
    _close(pbsdf.eval_null_transmission(sp, mp, si_p),
           jbsdf.eval_null_transmission(sj, mj, si_j), 'null transmission')
    for mode in (pbsdf.RADIANCE, pbsdf.IMPORTANCE):
        bs_p, w_p = pbsdf.sample(sp, mp, si_p, u1_p, u2_p, mode)
        bs_j, w_j = jbsdf.sample(sj, mj, si_j, u1_j, u2_j, mode)
        for f in ('delta', 'null'):
            assert (getattr(bs_p, f).numpy()
                    == np.asarray(getattr(bs_j, f))).all(), f
        live = np.asarray(bs_j.pdf) > 0
        assert (bs_p.pdf.numpy() > 0).tolist() == live.tolist()
        _close(bs_p.wo[torch.from_numpy(live)], np.asarray(bs_j.wo)[live],
               f'wo {mode}', DIR_ATOL)
        _close(bs_p.pdf, bs_j.pdf, f'pdf {mode}', rtol=SAMPLED_RTOL)
        _close(bs_p.eta, bs_j.eta, f'eta {mode}')
        _close(w_p, w_j, f'weight {mode}', rtol=SAMPLED_RTOL)
        assert np.isfinite(w_p.numpy()).all()


# --- reference behaviour that the port keeps ----------------------------------

@pytest.mark.parametrize('wrapper', ['twosided', 'mask'])
def test_nested_textures_are_not_registered(wrapper):
    """``twosided`` and ``mask`` pack their nested BSDF without
    registering its textures: the nested diffuse keeps the 0.5 fallback
    and no texture id, in both packages."""
    bsdf = {'type': wrapper, 'bsdf': {'type': 'diffuse', 'reflectance':
                                      _checker(0.9, 0.1)}}
    sj, mj, sp, mp = _scene(bsdf)
    row = sp.bsdfs.params[int(sp.shapes.bsdf_idx[0])].numpy()
    assert row[15] == -1.0 and (row[0:3] == 0.5).all()
    assert row.tobytes() == np.asarray(sj.bsdfs.params)[0].tobytes()
    assert not mp.has_textures and not mj.has_textures
    desc = pscenes.sphere_scene(spp=1, res=4)
    desc['shapes'][0]['bsdf'] = bsdf
    sq, mq = P.build_scene(desc, device='cpu')
    assert not mq.has_textures


def test_plain_rows_are_not_shared_but_wrapper_rows_are():
    """A plain BSDF dict shared by two shapes gets a row for each (the
    reference's id-keyed cache is written under another key), while a
    shared wrapper dict gets one row (its cache works): the port builds
    the same table."""
    plain = {'type': 'diffuse', 'reflectance': 0.3}
    wrap = {'type': 'normalmap', 'bsdf': {'type': 'diffuse'},
            'normalmap': _checker((0.5, 0.5, 1.0), (0.6, 0.4, 0.9))}
    desc = {'type': 'rectangle'}
    for pkg in (scenes, pscenes):
        d = pkg.sphere_scene(spp=1, res=4)
        d['shapes'] = [dict(desc, bsdf=plain), dict(desc, bsdf=plain),
                       dict(desc, bsdf=wrap), dict(desc, bsdf=wrap)]
        if pkg is scenes:
            sj, _ = J.build_scene(d)
        else:
            sp, _ = P.build_scene(d, device='cpu')
    assert np.asarray(sj.shapes.bsdf_idx).tolist() == [0, 1, 3, 3]
    assert sp.shapes.bsdf_idx.tolist() == [0, 1, 3, 3]
    assert sp.bsdfs.params.numpy().tobytes() == np.asarray(
        sj.bsdfs.params).tobytes()


def test_bumpmap_differences_are_in_uv():
    """The bump map tilts the normal by differences of the height in uv,
    not along the surface partials: the same uv on a rectangle scaled by
    0.5 and by 4 gives the same local result, in both packages."""
    out = []
    for scale in (0.5, 4.0):
        bump = {'type': 'bumpmap', 'scale': 0.3, 'bsdf': {'type': 'diffuse'},
                'bumpmap': _checker(0.0, 1.0, 1.0)}
        d = scenes.sphere_scene(spp=1, res=4)
        d['shapes'] = [{'type': 'rectangle', 'bsdf': bump,
                        'to_world': scenes.tr.scale(scale)}]
        sj, mj = J.build_scene(d)
        sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                    device='cpu')
        si_j, si_p, ((wo_j, wo_p), _, _) = _hits(sj, sp, 'upper', seed=3)
        f_p = pbsdf.eval(sp, mp, si_p, wo_p)
        _close(f_p, jbsdf.eval(sj, mj, si_j, wo_j), f'eval x{scale}')
        out.append(f_p.numpy())
    assert out[0].tobytes() == out[1].tobytes()


def test_plastic_grid3d_diffuse_reads_its_row():
    """A grid3d texture on a plastic's diffuse reflectance is looked up
    without the hit point (the reference's parameter rewrite passes uv
    only), so it reads its own row's first slots: the same in both
    packages, whatever the hit point."""
    grid = np.random.default_rng(8).uniform(0.2, 0.9, (4, 4, 4, 3)).astype(
        np.float32)
    bsdf = {'type': 'plastic', 'diffuse_reflectance': {
        'type': 'grid3d', 'grid': grid}}
    sj, mj, sp, mp = _scene(bsdf)
    assert mp.has_3d_textures and mp.has_param_textures
    si_j, si_p, ((wo_j, wo_p), _, _) = _hits(sj, sp, 'upper')
    f_p = pbsdf.eval(sp, mp, si_p, wo_p)
    _close(f_p, jbsdf.eval(sj, mj, si_j, wo_j), 'eval')
    moved = si_p._replace(p=si_p.p + 0.37)
    assert f_p.numpy().tobytes() == pbsdf.eval(sp, mp, moved,
                                               wo_p).numpy().tobytes()

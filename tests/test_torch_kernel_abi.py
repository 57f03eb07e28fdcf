"""The intersection kernel's binding, checked on the CPU.

The kernel itself runs only on the card (``python3 chip_smoke.py``, which
also checks the launch geometry the kernel works out for itself); what can
go wrong around it without showing here is checked here instead:

- the ctypes argument types against the ``extern "C"`` declarations of
  ``csrc/*.cu``, and the packed launch arguments and the geometry the
  library reports against the C structs (a pointer bound as ``c_int`` is
  cut to 32 bits, a field out of order hands the kernel a wrong pointer;
  both show only on the card);
- the wrapper's refusals, that any hit computes t alone on every device,
  and that the integrators hand it contiguous rays (it does not copy
  them)."""
import ctypes
import glob
import os
import re
import struct

import pytest
import torch

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
from mitsuba_nlvrl_tpu_torch.testing.scenes import cornell_box, sphere_scene

torch.set_num_threads(1)   # one intra-op thread a test worker

CSRC = os.path.join(os.path.dirname(os.path.dirname(kern.SOURCE)), 'csrc')

_C_TYPES = {'void*': ctypes.c_void_p, 'int': ctypes.c_int}


def c_declarations() -> dict:
    """{name: [ctypes type of each parameter]} of every extern "C" function
    in csrc/*.cu."""
    decls = {}
    for path in sorted(glob.glob(os.path.join(CSRC, '*.cu'))):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src):
            types = []
            for param in params.split(','):
                words = param.replace('*', ' * ').split()
                words = [w for w in words[:-1] if w != 'const']  # drop name
                ctype = ''.join(words)
                assert ctype in _C_TYPES, (name, param)
                types.append(_C_TYPES[ctype])
            decls[name] = types
    return decls


def abi_mismatches(decls: dict, argtypes: dict) -> list:
    """Differences between the C declarations and the bound argtypes."""
    out = [f'{n}: not bound' for n in decls if n not in argtypes]
    out += [f'{n}: not declared' for n in argtypes if n not in decls]
    for name in set(decls) & set(argtypes):
        c, py = decls[name], list(argtypes[name])
        if len(c) != len(py):
            out.append(f'{name}: {len(c)} parameters, {len(py)} argtypes')
        out += [f'{name} argument {i}: C {a.__name__}, ctypes {b.__name__}'
                for i, (a, b) in enumerate(zip(c, py)) if a is not b]
    return out


def c_struct_fields(name: str, source: str = kern.SOURCE) -> list:
    """[(type, field)] of ``struct name`` in a kernel's source."""
    with open(source) as f:
        src = f.read()
    body = re.search(rf'struct {name} {{(.*?)}};', src, re.S).group(1)
    return re.findall(r'(\w+) (\w+);', body)


# each C struct the wrapper reads or writes: (its Python field names, its
# struct.Struct, the one C type of every field and its struct code)
STRUCTS = {
    'LaunchArgs': (kern.LAUNCH_FIELDS, kern._PACK, 'int64_t', 'q'),
    'Geometry': (kern.GEOMETRY_FIELDS, kern._GEOMETRY, 'int32_t', 'i'),
}


def struct_mismatches(c_fields: list, py_fields, fmt: str, ctype: str,
                      code: str) -> list:
    """Differences between a C struct and the wrapper's packing of it."""
    out = [f'field {i}: C {c}, Python {p}'
           for i, (c, p) in enumerate(zip([f for _, f in c_fields],
                                          py_fields)) if c != p]
    if len(c_fields) != len(py_fields):
        out.append(f'{len(c_fields)} C fields, {len(py_fields)} Python')
    out += [f'{f}: {t}, not {ctype}' for t, f in c_fields if t != ctype]
    if fmt != f'<{len(c_fields)}{code}':
        out.append(f'packing {fmt!r} is not {len(c_fields)} {ctype}')
    return out


def test_c_declarations_found():
    decls = c_declarations()
    assert set(decls) == {'mnt_intersect_tris', 'mnt_intersect_geometry',
                          'mnt_intersect_tris_f64',
                          'mnt_intersect_geometry_f64'}
    assert decls['mnt_intersect_tris'] == [ctypes.c_void_p]
    assert decls['mnt_intersect_tris_f64'] == [ctypes.c_void_p]
    assert (decls['mnt_intersect_geometry_f64']
            == decls['mnt_intersect_geometry'])


def test_argtypes_match_c_declarations():
    assert abi_mismatches(c_declarations(),
                          {**kern.ARGTYPES, **kern.ARGTYPES_F64}) == []


@pytest.mark.parametrize('name,n_fields,source', [
    ('LaunchArgs', 15, kern.SOURCE), ('Geometry', 4, kern.SOURCE),
    ('LaunchArgs', 15, kern.SOURCE_F64), ('Geometry', 4, kern.SOURCE_F64)])
def test_structs_match_the_wrapper(name, n_fields, source):
    """The float64 kernel takes the float32 kernel's packed arguments and
    reports its launch in the same struct."""
    py_fields, packer, ctype, code = STRUCTS[name]
    fields = c_struct_fields(name, source)
    assert len(fields) == n_fields
    assert struct_mismatches(fields, py_fields, packer.format, ctype,
                             code) == []
    assert packer.size == struct.calcsize(f'<{n_fields}{code}')


@pytest.mark.parametrize('name,mutate', [
    ('mnt_intersect_tris', lambda t: [ctypes.c_int]),
    ('mnt_intersect_tris', lambda t: t + [ctypes.c_void_p]),
    ('mnt_intersect_tris', lambda t: []),
    ('mnt_intersect_geometry', lambda t: t[:-1] + [ctypes.c_int]),
    ('mnt_intersect_geometry', lambda t: t[:1] + [ctypes.c_void_p]
     + t[2:]),
    ('mnt_intersect_geometry', lambda t: t[:-1])])
def test_abi_check_catches_a_mismatch(name, mutate):
    """The comparison above fails for each kind of slip it guards."""
    bad = dict(kern.ARGTYPES)
    bad[name] = mutate(list(bad[name]))
    assert abi_mismatches(c_declarations(), bad)


@pytest.mark.parametrize('name,mutate', [
    ('LaunchArgs', lambda f, fmt: (f[1:2] + f[:1] + f[2:], fmt)),
    ('LaunchArgs', lambda f, fmt: (f[:-1], '<14q')),
    ('LaunchArgs', lambda f, fmt: (f + ('extra',), '<16q')),
    ('LaunchArgs', lambda f, fmt: (f, '<15i')),
    ('LaunchArgs', lambda f, fmt: (f[:13] + ('stream', 'v_out'), fmt)),
    ('Geometry', lambda f, fmt: (f[1:2] + f[:1] + f[2:], fmt)),
    ('Geometry', lambda f, fmt: (f, '<4q')),
    ('Geometry', lambda f, fmt: (f[:-1], '<3i'))])
def test_struct_check_catches_a_mismatch(name, mutate):
    py_fields, packer, ctype, code = STRUCTS[name]
    fields, fmt = mutate(tuple(py_fields), packer.format)
    assert struct_mismatches(c_struct_fields(name), fields, fmt, ctype,
                             code)


def _args(T=5, N=7):
    return ([torch.zeros((T, 3)) for _ in range(3)]
            + [torch.zeros((N, 3)), torch.zeros((N, 3)), torch.zeros(N),
               torch.zeros(N)])


@pytest.mark.parametrize('which,bad,err,match', [
    (0, torch.zeros((5, 3), dtype=torch.float64), TypeError, 'float32'),
    (1, torch.zeros((5, 4)), ValueError, 'e1 has shape'),
    (2, torch.zeros((4, 3)), ValueError, 'e2 has shape'),
    (3, torch.zeros((3, 7)).t(), ValueError, 'o must be contiguous'),
    (3, torch.zeros((7, 3), dtype=torch.float64), TypeError, 'float32'),
    (4, torch.zeros((3, 7)).t(), ValueError, 'd must be contiguous'),
    (5, torch.zeros(1).expand(7), ValueError, 'mint must be contiguous'),
    (6, torch.zeros(8), ValueError, 'maxt has shape'),
    (6, torch.zeros(7, dtype=torch.float16), TypeError, 'float32')])
def test_wrapper_refusals_name_the_argument(which, bad, err, match):
    args = _args()
    args[which] = bad
    with pytest.raises(err, match=match):
        kern._explain(*args)


def _double(desc):
    return dict(desc, double=True)


@pytest.mark.parametrize('desc', [
    lambda: cornell_box(spp=1, res=8,
                        integrator={'type': 'path', 'max_depth': 4}),
    lambda: sphere_scene(spp=1, res=8, bsdf={'type': 'dielectric'}),
    lambda: _double(cornell_box(spp=1, res=8,
                                integrator={'type': 'path',
                                            'max_depth': 4}))])
def test_render_hands_the_kernel_contiguous_rays(monkeypatch, desc):
    """The wrapper refuses strided rays on the card, and rays of another
    float type than the scene's, so every ray the integrator builds must
    be contiguous already and in the scene's type (float64 under the
    double variant)."""
    calls = []
    plain = kern.intersect_tris_plain
    d = desc()
    want = torch.float64 if d.get('double') else torch.float32

    def check(*args, any_hit=False):
        assert all(x.is_contiguous() for x in args)
        assert all(x.dtype == want for x in args)
        calls.append(any_hit)
        return plain(*args, any_hit=any_hit)
    monkeypatch.setattr(pisect, 'intersect_tris', check)
    scene, meta = P.build_scene(d, device='cpu')
    P.render(scene, meta, seed=0, spp=1)
    assert False in calls and True in calls


@pytest.mark.parametrize('T', [40, 0])
@pytest.mark.parametrize('fn', [kern.intersect_tris,
                                kern.intersect_tris_plain])
def test_any_hit_computes_t_alone(fn, T):
    """Any hit returns t and no idx, u or v, on the card as here, so a
    caller that reads them fails on both."""
    g = torch.Generator().manual_seed(5)
    tris = [torch.rand((T, 3), generator=g) - 0.5 for _ in range(3)]
    o = torch.rand((64, 3), generator=g) * 4 - 2
    d = -o / o.norm(dim=1, keepdim=True)
    rays = [o, d.contiguous(), torch.zeros(64), torch.full((64,), 10.0)]
    t, idx, u, v = fn(*tris, *rays, any_hit=True)
    assert (idx, u, v) == (None, None, None)
    t_near = fn(*tris, *rays)[0]
    assert torch.equal(torch.isfinite(t), torch.isfinite(t_near))
    assert bool(torch.isfinite(t).any()) == (T > 0)


@pytest.mark.parametrize('mint,maxt', [
    (None, None), (0.25, 7.0), ('tensor', 'tensor'), ('tensor', None),
    (None, 'tensor'), (0.25, 'tensor')])
def test_ray_bounds_are_contiguous(mint, maxt):
    """Ray.make fills scalar bounds (the integrators' shadow and spawned
    rays) instead of broadcasting them, so the wrapper takes them as they
    are."""
    from mitsuba_nlvrl_tpu_torch.core.ray import Ray
    o, d = torch.zeros((5, 3)), torch.ones((5, 3))
    lo = torch.linspace(0, 1, 5) if mint == 'tensor' else mint
    hi = torch.linspace(2, 3, 5) if maxt == 'tensor' else maxt
    ray = Ray.make(o, d, lo, hi)
    for bound, given in ((ray.mint, lo), (ray.maxt, hi)):
        assert bound.shape == (5,) and bound.is_contiguous()
        if given is not None:
            assert torch.equal(bound, torch.as_tensor(given).expand(5))

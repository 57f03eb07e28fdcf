"""Procedural scene descriptions: the port's copy of the reference's test
scenes (``tests/scenes.py``), built with the port's own transforms so a
program that must not import JAX (``chip_smoke.py``) can describe them;
``hetvol_box``, the Cornell box around a heterogeneous medium whose
density grid is made from a seed; ``cbox_nlvrl``, a stand-in for the
thesis's headline configuration (cbox-nonlinear-homo-vrl); and the
writers of two scene files, ``cbox_xml`` (the Cornell box as Mitsuba XML
over OBJ meshes) and ``cbox_mesh`` (the same box with a displaced
icosphere in a binary PLY, a stand-in for a real mesh); ``cbox_materials``,
the box dressed in the microfacet and plastic BSDFs; and the thesis's
option sets of ``cbox_nlvrl`` (``NLVRL_ANISO_OPTIONS``,
``NLVRL_RIS_BRE_OPTIONS``, ``hg_phase``); and the scenes of textures,
the wrapper BSDFs and the remaining lights, samplers and sensors:
``cbox_textured`` (a scene file with its bitmaps), ``env_spheres`` (an
environment-lit description with its EXR and PLY) and
``cbox_spot_directional``; and the spectral and polarized scenes:
``cbox_spectral`` (a scene file with a named conductor whose curves
``write_conductor_spd`` writes), ``cbox_polarized`` (optical elements,
polarizing materials, the ``stokes`` integrator) and ``albedo_grid_box``
(a heterogeneous medium with an albedo gridvolume)."""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core import transform as tr
from ..scene.vol_io import VolumeGrid

# the null cube that bounds a medium in the box, and its grid's bbox
MEDIUM_CUBE_SCALE = 0.95
# Gaussian blobs summed into hetvol_box's density
HETVOL_BLOBS = 8


def cornell_box(spp=4, res=32, integrator=None, light='area', medium=None,
                radiance=(10.0, 10.0, 10.0)):
    """An axis-aligned Cornell box built from rectangles, camera on -z;
    with ``medium``, a null cube (scale 0.95) holds it inside. ``radiance``
    is the area light's (an RGB triple or a spectrum dict such as
    ``cbox_light_spd()``)."""
    integrator = integrator or {'type': 'path', 'max_depth': 4}
    white = {'type': 'diffuse', 'reflectance': (0.7, 0.7, 0.7)}
    red = {'type': 'diffuse', 'reflectance': (0.6, 0.05, 0.05)}
    green = {'type': 'diffuse', 'reflectance': (0.05, 0.6, 0.05)}

    shapes = [
        # floor y=-1
        {'type': 'rectangle', 'bsdf': white,
         'to_world': tr.translate((0, -1, 0)) @ tr.rotate((1, 0, 0), -90)},
        # ceiling y=+1
        {'type': 'rectangle', 'bsdf': white,
         'to_world': tr.translate((0, 1, 0)) @ tr.rotate((1, 0, 0), 90)},
        # back wall z=+1
        {'type': 'rectangle', 'bsdf': white,
         'to_world': tr.translate((0, 0, 1)) @ tr.rotate((1, 0, 0), 180)},
        # left wall x=-1 (red), normal +x
        {'type': 'rectangle', 'bsdf': red,
         'to_world': tr.translate((-1, 0, 0)) @ tr.rotate((0, 1, 0), 90)},
        # right wall x=+1 (green), normal -x
        {'type': 'rectangle', 'bsdf': green,
         'to_world': tr.translate((1, 0, 0)) @ tr.rotate((0, 1, 0), -90)},
    ]
    emitters = []
    if light == 'area':
        shapes.append({
            'type': 'rectangle', 'bsdf': white,
            'emitter': {'type': 'area', 'radiance': radiance},
            'to_world': tr.translate((0, 0.99, 0)) @ tr.rotate((1, 0, 0), 90)
            @ tr.scale(0.3)})
    elif light == 'point':
        emitters.append({'type': 'point', 'position': (0, 0.5, 0),
                         'intensity': (3.0, 3.0, 3.0)})
    elif light == 'constant':
        emitters.append({'type': 'constant', 'radiance': (1.0, 1.0, 1.0)})

    if medium is not None:
        shapes.append({
            'type': 'cube', 'bsdf': {'type': 'null'},
            'interior': medium,
            'to_world': tr.scale(MEDIUM_CUBE_SCALE)})

    return {
        'integrator': integrator,
        'sensor': {
            'type': 'perspective', 'fov': 70.0, 'fov_axis': 'x',
            'near_clip': 0.01, 'far_clip': 100.0,
            'to_world': tr.look_at((0, 0, -3.2), (0, 0, 0), (0, 1, 0)),
            'film': {'width': res, 'height': res,
                     'rfilter': {'type': 'box'}},
            'sampler': {'type': 'independent', 'sample_count': spp},
        },
        'shapes': shapes,
        'emitters': emitters,
    }


def sphere_scene(spp=4, res=32, bsdf=None):
    """Single sphere on a ground plane under a constant environment."""
    return {
        'integrator': {'type': 'path', 'max_depth': 4},
        'sensor': {
            'type': 'perspective', 'fov': 45.0,
            'to_world': tr.look_at((0, 1, -4), (0, 0.5, 0), (0, 1, 0)),
            'film': {'width': res, 'height': res, 'rfilter': {'type': 'box'}},
            'sampler': {'type': 'independent', 'sample_count': spp},
        },
        'shapes': [
            {'type': 'sphere', 'center': (0, 0.5, 0), 'radius': 0.5,
             'bsdf': bsdf or {'type': 'diffuse', 'reflectance': 0.8}},
            {'type': 'rectangle',
             'bsdf': {'type': 'diffuse', 'reflectance': 0.5},
             'to_world': tr.rotate((1, 0, 0), -90) @ tr.scale(10)},
        ],
        'emitters': [{'type': 'constant', 'radiance': (1.0, 1.0, 1.0)}],
    }


def hetvol_density(grid_res: int, seed: int = 0) -> np.ndarray:
    """A (grid_res,)*3 float32 density in (z, y, x) order from
    ``numpy.random.default_rng(seed)``: a sum of ``HETVOL_BLOBS`` Gaussian
    blobs sampled at voxel centres, scaled into [0, 1], with voxels below
    1e-3 set to 0 so that the grid's corners hold whole vacuum blocks."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.25, 0.75, size=(HETVOL_BLOBS, 3))
    sigmas = rng.uniform(0.04, 0.1, size=HETVOL_BLOBS)
    amps = rng.uniform(0.5, 1.0, size=HETVOL_BLOBS)
    x = (np.arange(grid_res) + 0.5) / grid_res
    dens = np.zeros((grid_res,) * 3)
    for (cx, cy, cz), sg, a in zip(centres, sigmas, amps):
        ex, ey, ez = (np.exp(-(x - c) ** 2 / (2.0 * sg * sg))
                      for c in (cx, cy, cz))
        dens += a * ez[:, None, None] * ey[None, :, None] * ex[None, None, :]
    dens /= dens.max()
    dens[dens < 1e-3] = 0.0
    return dens.astype(np.float32)


def hetvol_medium(grid_res: int = 32, seed: int = 0, scale: float = 100.0):
    """A heterogeneous medium whose sigma_t is ``hetvol_density`` times
    ``scale`` over the medium cube, with HG phase (the builder's defaults:
    albedo 0.75, g = 0.8)."""
    half = MEDIUM_CUBE_SCALE
    grid = VolumeGrid(hetvol_density(grid_res, seed)[..., None],
                      np.full(3, -half, np.float32),
                      np.full(3, half, np.float32))
    return {'type': 'heterogeneous', 'scale': float(scale),
            'sigma_t': {'type': 'gridvolume', '_grid': grid},
            'phase': {'type': 'hg'}}


def hetvol_box(res_w=768, res_h=576, spp=2, grid_res=128, seed=0,
               scale=100.0, max_depth=8):
    """The Cornell box around a heterogeneous medium in its null cube:
    the film, sigma_t scale and HG phase of the reference's hetvol scene,
    with a density grid made from ``seed`` (``hetvol_density``), rendered
    by ``volpath`` with ``max_depth`` (8, the configuration's)."""
    desc = cornell_box(spp=spp, res=res_w,
                       integrator={'type': 'volpath',
                                   'max_depth': max_depth},
                       medium=hetvol_medium(grid_res, seed, scale))
    desc['sensor']['film']['height'] = res_h
    return desc


# cbox_nlvrl: the medium and laser values the headline configuration's
# scene file would give, chosen here (the file is not in the repository)
NLVRL_MEDIUM = {'type': 'nonlinear', 'sigma_t': 0.5, 'albedo': 0.8,
                'res_x': 1, 'res_y': 640, 'res_z': 1, 'bottom_ior': 1.0,
                'top_ior': 0.95, 'phase': {'type': 'isotropic'}}
# light paths start outside any medium, so the laser starts in front of
# the box and enters the medium cube through its open front (y ~ -0.52),
# rising across the IOR cells
LASER_ORIGIN = (0.0, -0.6, -1.5)
LASER_DIRECTION = (0.0, 0.15, 1.0)
# every bend segment is a VRL (a bend of the laser crosses about 0.02 of
# the box between IOR cells; the reference's default minimum is 5)
NLVRL_MIN_VRL_LENGTH = 0.0


def cbox_nlvrl(res_w=512, res_h=256, spp=2, target_vrls=8000,
               integrator='vrl', **props):
    """The Cornell box around a nonlinear medium (an IOR grid of 1 x 640 x
    1 cells from 1.0 at the bottom to 0.95 at the top) lit by a laser:
    ``vrl`` with ``target_vrls`` VRLs, cluster VRL selection, bent light
    and camera rays, 2 samples a VRL query and the reference's depth
    defaults (camera max_depth 512, 64 camera iterations and 64 light
    bounces at most, 32 bends), every bend segment a VRL.
    ``integrator='photonmapper'`` renders the
    same box with the photon mapper; ``props`` override integrator
    properties (the tests shrink the caps)."""
    integ = {'type': integrator, 'target_vrls': target_vrls,
             'use_light_cut': True, 'use_non_linear': True,
             'use_non_linear_camera': True, 'samples_per_query': 2,
             'use_laser': True, 'laser_origin': LASER_ORIGIN,
             'laser_direction': LASER_DIRECTION, 'max_nl_bends': 32,
             'min_vrl_length': NLVRL_MIN_VRL_LENGTH, **props}
    desc = cornell_box(spp=spp, res=res_w, integrator=integ,
                       medium=dict(NLVRL_MEDIUM))
    desc['sensor']['film']['height'] = res_h
    return desc


# --- scene files -----------------------------------------------------------

# the area light's SPD in the reference's cbox.xml (wavelength nm: value)
CBOX_LIGHT_SPD = ((400.0, 0.0), (500.0, 8.0), (600.0, 15.6), (700.0, 18.4))


def cbox_light_spd() -> dict:
    """``CBOX_LIGHT_SPD`` as the XML loader gives an emitter's spectrum."""
    return {'type': 'irregular', 'value': list(CBOX_LIGHT_SPD)}


def _world_mesh(sh: dict):
    """A rectangle shape's triangles in world space as the builder makes
    them: float32 vertices, normals, uvs and (winding-corrected) faces."""
    from ..scene.builder import _rectangle_mesh
    mesh = _rectangle_mesh()
    M = np.asarray(sh['to_world'].m, np.float64)
    Minv = np.asarray(sh['to_world'].inv, np.float64)
    v = (mesh.vertices @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    n = mesh.normals @ Minv[:3, :3]
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    faces = mesh.faces
    if np.linalg.det(M[:3, :3]) < 0:
        faces = faces[:, [0, 2, 1]]
    return v, n, mesh.uvs, faces


def _num(x) -> str:
    """A float32 written so that reading it back gives the same float32."""
    return repr(float(np.float32(x)))


def _write_obj(path: str, v, n, uv, faces) -> None:
    with open(path, 'w') as f:
        for rows, tag in ((v, 'v'), (uv, 'vt'), (n, 'vn')):
            for r in rows:
                f.write(tag + ' ' + ' '.join(_num(x) for x in r) + '\n')
        for tri in faces:
            f.write('f ' + ' '.join(f'{i + 1}/{i + 1}/{i + 1}' for i in tri)
                    + '\n')


def _write_ply(path: str, v, faces) -> None:
    """Binary little-endian PLY: float x, y, z and uchar/int face lists."""
    header = (f"ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\nproperty float x\n"
              f"property float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              f"property list uchar int vertex_indices\nend_header\n")
    rec = np.zeros(len(faces), np.dtype([('n', 'u1'), ('i', '<i4', (3,))]))
    rec['n'] = 3
    rec['i'] = faces
    with open(path, 'wb') as f:
        f.write(header.encode('ascii'))
        f.write(np.ascontiguousarray(v, '<f4').tobytes())
        f.write(rec.tobytes())


def _rgb(c) -> str:
    return ', '.join(_num(x) for x in c)


def _xml(spp: int, res_w: int, res_h: int, max_depth: int,
         shapes: list) -> str:
    """A Mitsuba 2 scene: the camera, film and integrator of
    ``cornell_box`` and ``shapes`` as (filename, type, rgb reflectance,
    emitter or not)."""
    spd = ', '.join(f'{w:g}:{v:g}' for w, v in CBOX_LIGHT_SPD)
    out = ['<?xml version="1.0" encoding="utf-8"?>',
           '<scene version="2.0.0">',
           f'    <integrator type="path">',
           f'        <integer name="max_depth" value="{max_depth}"/>',
           '    </integrator>',
           '    <sensor type="perspective">',
           '        <float name="fov" value="70"/>',
           '        <string name="fov_axis" value="x"/>',
           '        <float name="near_clip" value="0.01"/>',
           '        <float name="far_clip" value="100"/>',
           '        <transform name="to_world">',
           '            <lookat origin="0, 0, -3.2" target="0, 0, 0" '
           'up="0, 1, 0"/>',
           '        </transform>',
           '        <sampler type="independent">',
           f'            <integer name="sample_count" value="{spp}"/>',
           '        </sampler>',
           '        <film type="hdrfilm">',
           f'            <integer name="width" value="{res_w}"/>',
           f'            <integer name="height" value="{res_h}"/>',
           '            <rfilter type="box"/>',
           '        </film>',
           '    </sensor>']
    for fname, kind, rgb, emits in shapes:
        out += [f'    <shape type="{kind}">',
                f'        <string name="filename" value="{fname}"/>',
                '        <bsdf type="diffuse">',
                f'            <rgb name="reflectance" value="{_rgb(rgb)}"/>',
                '        </bsdf>']
        if emits:
            out += ['        <emitter type="area">',
                    f'            <spectrum name="radiance" value="{spd}"/>',
                    '        </emitter>']
        out.append('    </shape>')
    out.append('</scene>')
    return '\n'.join(out) + '\n'


_CBOX_NAMES = ('floor', 'ceiling', 'back', 'left', 'right', 'light')


def _cbox_shapes(directory: str) -> list:
    """Writes the walls and the light of ``cornell_box`` as OBJ files in
    world space; returns their (filename, type, reflectance, emits)."""
    out = []
    for name, sh in zip(_CBOX_NAMES, cornell_box(light='area')['shapes']):
        _write_obj(os.path.join(directory, f'{name}.obj'), *_world_mesh(sh))
        out.append((f'{name}.obj', 'obj', sh['bsdf']['reflectance'],
                    'emitter' in sh))
    return out


def cbox_xml(directory: str, spp: int = 16, res: int = 512,
             max_depth: int = 8) -> str:
    """Writes ``cbox.xml`` and its OBJ meshes into ``directory`` and
    returns the scene file's path: the scene of ``cornell_box(spp, res,
    {'type': 'path', 'max_depth': max_depth}, radiance=cbox_light_spd())``
    (walls and light in world space, the light's radiance the reference
    cbox.xml's SPD), so both routes build the same arrays."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, 'cbox.xml')
    with open(path, 'w') as f:
        f.write(_xml(spp, res, res, max_depth, _cbox_shapes(directory)))
    return path


# the displaced icosphere of cbox_mesh: centre, radius, relative amplitude
# of the displacement along the normals, reflectance
MESH_CENTER = (0.0, -0.45, 0.2)
MESH_RADIUS = 0.5
MESH_DISPLACEMENT = 0.06
MESH_REFLECTANCE = (0.75, 0.65, 0.4)


def displaced_icosphere(subdiv: int = 5, seed: int = 0):
    """(vertices, faces) of an icosphere of ``subdiv`` subdivisions (20 *
    4**subdiv triangles) whose vertices are pushed along their normals by
    ``numpy.random.default_rng(seed)`` noise, placed in the box."""
    from ..scene.builder import icosphere_mesh
    mesh = icosphere_mesh(subdiv)
    rng = np.random.default_rng(seed)
    r = MESH_RADIUS * (1.0 + MESH_DISPLACEMENT
                       * rng.uniform(-1.0, 1.0, len(mesh.vertices)))
    v = mesh.vertices.astype(np.float64) * r[:, None] + MESH_CENTER
    return v.astype(np.float32), mesh.faces


def cbox_mesh(directory: str, subdiv: int = 5, seed: int = 0,
              spp: int = 16, res: int = 512, max_depth: int = 8) -> str:
    """Writes ``cbox_mesh.xml``: the scene of ``cbox_xml`` with the
    ``displaced_icosphere`` in a binary little-endian PLY
    (``sphere.ply``); returns the scene file's path. At subdivision 5 the
    scene has 20,492 triangles, at 3 1,292: both get a BVH."""
    os.makedirs(directory, exist_ok=True)
    _write_ply(os.path.join(directory, 'sphere.ply'),
               *displaced_icosphere(subdiv, seed))
    shapes = _cbox_shapes(directory) + [
        ('sphere.ply', 'ply', MESH_REFLECTANCE, False)]
    path = os.path.join(directory, 'cbox_mesh.xml')
    with open(path, 'w') as f:
        f.write(_xml(spp, res, res, max_depth, shapes))
    return path


# --- the thesis's options and the materials ---------------------------------

# cbox_nlvrl_aniso: the golden cbox-nl-hg-vrl-aniso's options (tabulated
# anisotropic camera CDF, diced and lengthened VRLs) with HG g = 0.8
NLVRL_ANISO_OPTIONS = {'vrl_aniso_cdf': True, 'dice_vrl': 4,
                       'long_vrl': True}
NLVRL_ANISO_G = 0.8
# cbox_nlvrl_ris_bre: RIS VRL selection and the beam radiance estimate
NLVRL_RIS_BRE_OPTIONS = {'vrl_ris': True, 'use_bre': True}


def hg_phase(desc: dict, g: float = NLVRL_ANISO_G) -> dict:
    """``desc`` with every medium's phase set to HG with ``g``."""
    for sh in desc['shapes']:
        for side in ('interior', 'exterior'):
            if sh.get(side) is not None:
                sh[side] = dict(sh[side], phase={'type': 'hg', 'g': g})
    return desc


# cbox_materials: the BSDFs of each shape (values chosen for the test
# scene; the rough plastic's Beckmann is recorded as the reference reads
# it: its rough lobes are GGX whatever the distribution)
MATERIALS = {
    'floor': {'type': 'twosided',
              'bsdf': {'type': 'diffuse', 'reflectance': (0.7, 0.7, 0.7)}},
    'back_wall': {'type': 'plastic', 'diffuse_reflectance': (0.7, 0.7, 0.7),
                  'int_ior': 1.5},
    'tall_block': {'type': 'roughconductor', 'distribution': 'ggx',
                   'alpha': 0.2, 'eta': (0.143, 0.374, 1.442),
                   'k': (3.983, 2.385, 1.603)},
    'short_block': {'type': 'roughplastic', 'distribution': 'beckmann',
                    'alpha': 0.15, 'diffuse_reflectance': (0.1, 0.25, 0.6),
                    'int_ior': 1.49},
    'glass_sphere': {'type': 'roughdielectric', 'alpha': 0.1,
                     'int_ior': 1.5},
    'pane': {'type': 'thindielectric', 'int_ior': 1.5},
    'pplastic_sphere': {'type': 'pplastic',
                        'diffuse_reflectance': (0.6, 0.3, 0.05),
                        'alpha': 0.06},
}


def dress_materials(desc: dict, tr_mod=tr) -> dict:
    """Dress a ``cornell_box`` description in ``MATERIALS``: the floor and
    the back wall change BSDF, and two blocks, two spheres and a vertical
    pane join the box. ``tr_mod`` makes the transforms (this package's
    ``core.transform`` unless a caller passes another with the same
    functions)."""
    shapes = desc['shapes']
    shapes[0]['bsdf'] = MATERIALS['floor']
    shapes[2]['bsdf'] = MATERIALS['back_wall']
    shapes += [
        {'type': 'cube', 'bsdf': MATERIALS['tall_block'],
         'to_world': tr_mod.translate((-0.35, -0.4, 0.35))
         @ tr_mod.rotate((0, 1, 0), 15) @ tr_mod.scale((0.28, 0.6, 0.28))},
        {'type': 'cube', 'bsdf': MATERIALS['short_block'],
         'to_world': tr_mod.translate((0.4, -0.7, -0.25))
         @ tr_mod.rotate((0, 1, 0), -18) @ tr_mod.scale((0.28, 0.3, 0.28))},
        {'type': 'sphere', 'center': (0.4, -0.14, -0.25), 'radius': 0.25,
         'bsdf': MATERIALS['glass_sphere']},
        {'type': 'sphere', 'center': (-0.5, -0.75, -0.5), 'radius': 0.25,
         'bsdf': MATERIALS['pplastic_sphere']},
        {'type': 'rectangle', 'bsdf': MATERIALS['pane'],
         'to_world': tr_mod.translate((0.05, -0.65, -0.75))
         @ tr_mod.rotate((0, 1, 0), 30) @ tr_mod.scale((0.25, 0.35, 1.0))},
    ]
    return desc


def cbox_materials(res_w=512, res_h=512, spp=16, integrator=None,
                   medium=None):
    """The Cornell box in ``MATERIALS`` (``dress_materials``), by default
    under ``path`` with max_depth 8."""
    desc = cornell_box(spp=spp, res=res_w, medium=medium,
                       integrator=integrator or {'type': 'path',
                                                 'max_depth': 8})
    desc['sensor']['film']['height'] = res_h
    return dress_materials(desc)


# cbox_materials_pm: the materials box filled with a homogeneous medium
# (in the null cube) under the photon mapper
MATERIALS_MEDIUM = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8}
MATERIALS_PM = {'type': 'photonmapper', 'max_depth': 8,
                'global_photons': 100000, 'volume_photons': 100000}


def cbox_materials_pm(res_w=512, res_h=256, spp=2, **props):
    """``cbox_materials`` around ``MATERIALS_MEDIUM`` under the photon
    mapper (``MATERIALS_PM``; ``props`` override its properties): its
    camera gathers on the rough and plastic surfaces evaluate the BSDF
    once a photon."""
    return cbox_materials(res_w, res_h, spp, medium=dict(MATERIALS_MEDIUM),
                          integrator={**MATERIALS_PM, **props})


# --- textures, the wrapper BSDFs, the remaining lights, samplers and sensors

# cbox_textured: the chosen values of the scene file (no reference scene of
# it is in the repository)
TEXTURED_BITMAP_RES = 256       # the back wall's picture
TEXTURED_MAP_RES = 64           # the parameter maps
TEXTURED_APERTURE = 0.02        # the thin lens: radius and focus distance
TEXTURED_FOCUS = 3.2
TEXTURED_BUMP_SCALE = 0.02


def _noise(rng, res: int, octaves: int = 3) -> np.ndarray:
    """A smooth (res, res) field in [0, 1]: a few octaves of bilinearly
    upsampled uniform noise."""
    out = np.zeros((res, res))
    for k in range(octaves):
        n = 4 << k
        g = rng.uniform(0.0, 1.0, (n + 1, n + 1))
        x = np.linspace(0.0, n, res)
        i = np.minimum(x.astype(int), n - 1)
        f = x - i
        rows = g[i] * (1 - f)[:, None] + g[i + 1] * f[:, None]
        out += (rows[:, i] * (1 - f) + rows[:, i + 1] * f) / (2 ** k)
    out -= out.min()
    return out / max(out.max(), 1e-12)


def textured_bitmaps(directory: str, seed: int = 0) -> dict:
    """Writes the PNGs of ``cbox_textured`` from
    ``numpy.random.default_rng(seed)``: the back wall's colour picture
    (``wall.png``, sRGB) and the raw parameter maps ``alpha.png``
    (roughness 0.05-0.4), ``normal.png`` (a tangent-space normal map),
    ``height.png``, ``weight.png`` (a blend weight) and ``opacity.png``
    (a mask with holes). Returns their file names by role."""
    from ..utils.io import write_png
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    R, r = TEXTURED_BITMAP_RES, TEXTURED_MAP_RES
    wall = np.stack([_noise(rng, R), _noise(rng, R), _noise(rng, R)], -1)
    yy, xx = np.mgrid[0:R, 0:R] / R
    stripes = 0.5 + 0.5 * np.sin(2 * np.pi * 6 * (xx + 0.3 * yy))
    wall = 0.15 + 0.7 * (0.6 * wall + 0.4 * stripes[..., None]
                         * np.array([0.9, 0.6, 0.3]))
    h = _noise(rng, r)
    gy, gx = np.gradient(h)
    n = np.stack([-4.0 * gx * r / 8, -4.0 * gy * r / 8, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    maps = {
        'wall': wall,
        'alpha': 0.05 + 0.35 * _noise(rng, r),
        'normal': 0.5 * (n + 1.0),
        'height': h,
        'weight': _noise(rng, r),
        'opacity': (_noise(rng, r) > 0.35).astype(np.float64),
    }
    names = {}
    for role, img in maps.items():
        names[role] = f'{role}.png'
        write_png(os.path.join(directory, names[role]),
                  np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img,
                  gamma=role == 'wall')
    return names


def uv_cube():
    """A unit cube (half-extent 1) with four vertices a face, each face's
    uv spanning [0, 1]^2: (vertices, normals, uvs, faces)."""
    v, n, uv, f = [], [], [], []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            nrm = np.zeros(3)
            nrm[axis] = sgn
            a, b = [k for k in range(3) if k != axis]
            base = len(v)
            for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[axis], p[a], p[b] = sgn, su * sgn, sv
                v.append(p)
                n.append(nrm)
                uv.append(((su + 1) / 2, (sv + 1) / 2))
            f += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.asarray(v, np.float32), np.asarray(n, np.float32),
            np.asarray(uv, np.float32), np.asarray(f, np.int32))


def _tf(ops) -> list:
    """XML transform children: ``ops`` applied in order, each ('scale',
    xyz), ('rotate', axis, deg) or ('translate', xyz)."""
    out = []
    for op in ops:
        if op[0] == 'rotate':
            x, y, z = op[1]
            out.append(f'<rotate x="{x}" y="{y}" z="{z}" angle="{op[2]}"/>')
        else:
            x, y, z = op[1]
            out.append(f'<{op[0]} x="{_num(x)}" y="{_num(y)}" '
                       f'z="{_num(z)}"/>')
    return ['<transform name="to_world">'] + ['    ' + o for o in out] \
        + ['</transform>']


def _indent(lines, n):
    return [' ' * n + x for x in lines]


# the rooms' walls as (name, transform ops); the floor, back wall and
# ceiling light differ by scene
_WALLS = (('floor', [('rotate', (1, 0, 0), -90), ('translate', (0, -1, 0))]),
          ('ceiling', [('rotate', (1, 0, 0), 90), ('translate', (0, 1, 0))]),
          ('back', [('rotate', (1, 0, 0), 180), ('translate', (0, 0, 1))]),
          ('left', [('rotate', (0, 1, 0), 90), ('translate', (-1, 0, 0))]),
          ('right', [('rotate', (0, 1, 0), -90), ('translate', (1, 0, 0))]))


def cbox_textured(directory: str, spp: int = 16, res: int = 512,
                  max_depth: int = 8, seed: int = 0,
                  bitmap: str = None) -> str:
    """Writes ``cbox_textured.xml`` with its PNGs (``textured_bitmaps``)
    and a uv-mapped cube OBJ into ``directory``; returns its path. The
    Cornell box under a ``multijitter`` sampler and a ``thinlens``
    camera, ``path`` with ``max_depth``: a ``checkerboard`` floor, a
    back wall with a ``bitmap`` picture, a ``normalmap`` block over a
    ``roughconductor`` whose alpha is a bitmap, a ``bumpmap`` block over
    a ``roughplastic`` with a checkerboard diffuse reflectance, a
    ``blendbsdf`` sphere with a bitmap weight, a ``mask`` pane with a
    bitmap opacity, two spheres placed by one ``shapegroup`` and two
    ``instance``s, the ceiling light and a ``spot``. 38 triangles and 3
    analytic spheres. With ``bitmap`` (a file path) every bitmap texture
    reads that one file instead."""
    os.makedirs(directory, exist_ok=True)
    tex = textured_bitmaps(directory, seed)
    if bitmap is not None:
        tex = {role: os.path.abspath(bitmap) for role in tex}
    _write_obj(os.path.join(directory, 'block.obj'), *uv_cube())

    def bitmap(name, role, raw=True):
        return [f'<texture name="{name}" type="bitmap">',
                f'    <string name="filename" value="{tex[role]}"/>',
                f'    <boolean name="raw" value="{str(raw).lower()}"/>',
                '</texture>']

    def diffuse(rgb):
        return ['<bsdf type="diffuse">',
                f'    <rgb name="reflectance" value="{_rgb(rgb)}"/>',
                '</bsdf>']

    def checker(name, c0, c1, scale):
        return [f'<texture name="{name}" type="checkerboard">',
                f'    <rgb name="color0" value="{_rgb(c0)}"/>',
                f'    <rgb name="color1" value="{_rgb(c1)}"/>',
                f'    <float name="uscale" value="{scale}"/>',
                f'    <float name="vscale" value="{scale}"/>',
                '</texture>']

    def shape(kind, body, ops=(), extra=()):
        return _indent([f'<shape type="{kind}">', *_indent(list(extra), 4),
                        *_indent(_tf(ops) if ops else [], 4),
                        *_indent(body, 4), '</shape>'], 4)

    white = (0.7, 0.7, 0.7)
    walls = dict(_WALLS)
    out = ['<?xml version="1.0" encoding="utf-8"?>',
           '<scene version="2.0.0">',
           '    <integrator type="path">',
           f'        <integer name="max_depth" value="{max_depth}"/>',
           '    </integrator>',
           '    <sensor type="thinlens">',
           '        <float name="fov" value="70"/>',
           '        <string name="fov_axis" value="x"/>',
           f'        <float name="aperture_radius" value="{TEXTURED_APERTURE}"/>',
           f'        <float name="focus_distance" value="{TEXTURED_FOCUS}"/>',
           '        <float name="near_clip" value="0.01"/>',
           '        <float name="far_clip" value="100"/>',
           '        <transform name="to_world">',
           '            <lookat origin="0, 0, -3.2" target="0, 0, 0" '
           'up="0, 1, 0"/>',
           '        </transform>',
           '        <sampler type="multijitter">',
           f'            <integer name="sample_count" value="{spp}"/>',
           '        </sampler>',
           '        <film type="hdrfilm">',
           f'            <integer name="width" value="{res}"/>',
           f'            <integer name="height" value="{res}"/>',
           '            <rfilter type="box"/>',
           '        </film>',
           '    </sensor>']
    out += shape('rectangle', ['<bsdf type="diffuse">', *_indent(checker(
        'reflectance', (0.8, 0.8, 0.75), (0.15, 0.15, 0.2), 4), 4),
        '</bsdf>'], walls['floor'])
    out += shape('rectangle', diffuse(white), walls['ceiling'])
    out += shape('rectangle', ['<bsdf type="diffuse">',
                               *_indent(bitmap('reflectance', 'wall',
                                               raw=False), 4), '</bsdf>'],
                 walls['back'])
    out += shape('rectangle', diffuse((0.6, 0.05, 0.05)), walls['left'])
    out += shape('rectangle', diffuse((0.05, 0.6, 0.05)), walls['right'])
    out += shape('rectangle', diffuse(white) + [
        '<emitter type="area">',
        '    <rgb name="radiance" value="10, 10, 10"/>',
        '</emitter>'], [('scale', (0.3, 0.3, 0.3)),
                        ('rotate', (1, 0, 0), 90),
                        ('translate', (0, 0.99, 0))])
    out += shape('obj', [
        '<bsdf type="normalmap">', *_indent(bitmap('normalmap', 'normal'), 4),
        '    <bsdf type="roughconductor">',
        *_indent(bitmap('alpha', 'alpha'), 8),
        '        <rgb name="eta" value="0.143, 0.374, 1.442"/>',
        '        <rgb name="k" value="3.983, 2.385, 1.603"/>',
        '    </bsdf>', '</bsdf>'],
        [('scale', (0.28, 0.6, 0.28)), ('rotate', (0, 1, 0), 15),
         ('translate', (-0.35, -0.4, 0.35))],
        ['<string name="filename" value="block.obj"/>'])
    out += shape('obj', [
        '<bsdf type="bumpmap">', *_indent(bitmap('bumpmap', 'height'), 4),
        f'    <float name="scale" value="{TEXTURED_BUMP_SCALE}"/>',
        '    <bsdf type="roughplastic">',
        '        <float name="alpha" value="0.15"/>',
        *_indent(checker('diffuse_reflectance', (0.1, 0.25, 0.6),
                         (0.6, 0.5, 0.1), 3), 8),
        '    </bsdf>', '</bsdf>'],
        [('scale', (0.28, 0.3, 0.28)), ('rotate', (0, 1, 0), -18),
         ('translate', (0.4, -0.7, -0.25))],
        ['<string name="filename" value="block.obj"/>'])
    out += shape('sphere', [
        '<bsdf type="blendbsdf">', *_indent(bitmap('weight', 'weight'), 4),
        '    <bsdf type="roughconductor">',
        '        <float name="alpha" value="0.05"/>',
        '    </bsdf>', *_indent(diffuse((0.7, 0.2, 0.1)), 4), '</bsdf>'],
        extra=['<point name="center" x="0.4" y="-0.14" z="-0.25"/>',
               '<float name="radius" value="0.25"/>'])
    out += shape('rectangle', [
        '<bsdf type="mask">', *_indent(bitmap('opacity', 'opacity'), 4),
        *_indent(diffuse((0.2, 0.5, 0.8)), 4), '</bsdf>'],
        [('scale', (0.25, 0.35, 1.0)), ('rotate', (0, 1, 0), 30),
         ('translate', (0.05, -0.65, -0.75))])
    out += _indent(['<shape type="shapegroup" id="pebbles">',
                    '    <shape type="sphere">',
                    '        <float name="radius" value="0.12"/>',
                    *_indent(diffuse((0.8, 0.7, 0.3)), 8),
                    '    </shape>', '</shape>'], 4)
    for pos in ((-0.55, -0.88, -0.45), (0.65, 0.3, 0.5)):
        out += shape('instance', ['<ref id="pebbles"/>'],
                     [('translate', pos)])
    out += ['    <emitter type="spot">',
            '        <point name="position" x="-0.6" y="0.9" z="-0.6"/>',
            '        <vector name="direction" x="0.5" y="-1" z="0.6"/>',
            '        <rgb name="intensity" value="6, 5, 4"/>',
            '        <float name="cutoff_angle" value="25"/>',
            '    </emitter>', '</scene>']
    path = os.path.join(directory, 'cbox_textured.xml')
    with open(path, 'w') as f:
        f.write('\n'.join(out) + '\n')
    return path


# env_spheres: the chosen values (no reference scene of it is in the
# repository)
ENV_SKY_RES = (512, 256)
ENV_ICOSPHERE_SUBDIV = 2
ENV_GRID_RES = 8


def sky_exr(path: str, res=ENV_SKY_RES, seed: int = 0) -> None:
    """An equirectangular sky from ``numpy.random.default_rng(seed)``: a
    zenith-to-horizon gradient, noisy clouds, a bright sun and a dark
    ground, written as an RGB EXR."""
    from ..utils.io import write_exr
    W, H = res
    rng = np.random.default_rng(seed)
    theta = (np.arange(H) + 0.5) / H * np.pi
    phi = (np.arange(W) + 0.5) / W * 2 * np.pi
    t, p = np.meshgrid(theta, phi, indexing='ij')
    up = np.clip(t / (0.5 * np.pi), 0.0, 1.0)[..., None]
    img = np.array([0.3, 0.5, 1.1]) * (1 - up) + np.array([1.0, 0.95, 0.9]) \
        * up
    clouds = _noise(rng, max(W, H))[:H, :W]
    img = img * (0.7 + 0.6 * clouds[..., None])
    img[t > 0.5 * np.pi] = np.array([0.2, 0.16, 0.12])
    sun = np.array([np.cos(np.radians(35)) * np.cos(1.0),
                    np.cos(np.radians(35)) * np.sin(1.0),
                    np.sin(np.radians(35))])
    d = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 -1)
    img[d @ sun[[0, 1, 2]] > np.cos(np.radians(3.0))] = (80.0, 70.0, 55.0)
    write_exr(path, img.astype(np.float32))


def colored_icosphere_ply(path: str, subdiv: int = ENV_ICOSPHERE_SUBDIV,
                          seed: int = 0) -> int:
    """A unit icosphere in a binary PLY with float vertex colours from
    ``numpy.random.default_rng(seed)``; returns its triangle count."""
    from ..scene.builder import icosphere_mesh
    mesh = icosphere_mesh(subdiv)
    rng = np.random.default_rng(seed)
    col = rng.uniform(0.1, 0.9, (len(mesh.vertices), 3)).astype(np.float32)
    v = mesh.vertices
    header = (f"ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\nproperty float x\n"
              f"property float y\nproperty float z\nproperty float red\n"
              f"property float green\nproperty float blue\n"
              f"element face {len(mesh.faces)}\n"
              f"property list uchar int vertex_indices\nend_header\n")
    rec = np.zeros(len(mesh.faces),
                   np.dtype([('n', 'u1'), ('i', '<i4', (3,))]))
    rec['n'] = 3
    rec['i'] = mesh.faces
    with open(path, 'wb') as f:
        f.write(header.encode('ascii'))
        f.write(np.ascontiguousarray(np.concatenate([v, col], 1),
                                     '<f4').tobytes())
        f.write(rec.tobytes())
    return len(mesh.faces)


def env_grid(res: int = ENV_GRID_RES, seed: int = 0) -> np.ndarray:
    """The (res, res, res, 3) colour volume of env_spheres' grid3d
    texture."""
    rng = np.random.default_rng(seed + 1)
    return rng.uniform(0.05, 0.95, (res, res, res, 3)).astype(np.float32)


def env_spheres(directory: str, res_w: int = 512, res_h: int = 512,
                spp: int = 16, max_depth: int = 8, seed: int = 0,
                tr_mod=tr, integrator=None) -> dict:
    """Writes ``sky.exr`` (``sky_exr``) and ``ico.ply``
    (``colored_icosphere_ply``) into ``directory`` and returns the
    description: a ``checkerboard`` ground; a ``roughconductor``, a
    ``roughdielectric`` and a ``plastic`` sphere whose diffuse
    reflectance is a ``grid3d`` texture given as an array; the vertex-
    coloured icosphere under ``mesh_attribute``; lit by the ``envmap``, a
    ``directional`` sun and a ``projector`` with a checkerboard slide;
    ``stratified`` sampler, ``path`` with ``max_depth``. ``tr_mod`` makes
    the transforms."""
    os.makedirs(directory, exist_ok=True)
    sky = os.path.join(directory, 'sky.exr')
    sky_exr(sky, seed=seed)
    ply = os.path.join(directory, 'ico.ply')
    colored_icosphere_ply(ply, seed=seed)
    c_plastic = (-0.35, 0.3, -0.9)
    return {
        'integrator': integrator or {'type': 'path',
                                     'max_depth': max_depth},
        'sensor': {
            'type': 'perspective', 'fov': 50.0,
            'to_world': tr_mod.look_at((0, 1.2, -4.2), (0, 0.3, 0),
                                       (0, 1, 0)),
            'film': {'width': res_w, 'height': res_h,
                     'rfilter': {'type': 'box'}},
            'sampler': {'type': 'stratified', 'sample_count': spp}},
        'shapes': [
            {'type': 'rectangle',
             'bsdf': {'type': 'diffuse', 'reflectance': {
                 'type': 'checkerboard', 'color0': (0.7, 0.7, 0.7),
                 'color1': (0.2, 0.2, 0.25), 'uscale': 8.0,
                 'vscale': 8.0}},
             'to_world': tr_mod.rotate((1, 0, 0), -90) @ tr_mod.scale(6)},
            {'type': 'sphere', 'center': (-1.1, 0.45, 0.3), 'radius': 0.45,
             'bsdf': {'type': 'roughconductor', 'alpha': 0.15,
                      'eta': (0.2, 0.92, 1.1), 'k': (3.9, 2.45, 2.14)}},
            {'type': 'sphere', 'center': (0.0, 0.45, 0.6), 'radius': 0.45,
             'bsdf': {'type': 'roughdielectric', 'alpha': 0.08,
                      'int_ior': 1.5}},
            {'type': 'sphere', 'center': c_plastic, 'radius': 0.3,
             'bsdf': {'type': 'plastic', 'int_ior': 1.5,
                      'diffuse_reflectance': {
                          'type': 'grid3d', 'grid': env_grid(seed=seed),
                          'bbox_min': tuple(x - 0.3 for x in c_plastic),
                          'bbox_max': tuple(x + 0.3 for x in c_plastic)}}},
            {'type': 'ply', 'filename': ply,
             'bsdf': {'type': 'diffuse', 'reflectance': {
                 'type': 'mesh_attribute', 'name': 'vertex_color'}},
             'to_world': tr_mod.translate((1.15, 0.4, 0.2))
             @ tr_mod.scale(0.4)},
        ],
        'emitters': [
            {'type': 'envmap', 'filename': sky, 'scale': 1.0},
            {'type': 'directional', 'direction': (-0.4, -1.0, 0.5),
             'irradiance': (2.0, 1.8, 1.5)},
            {'type': 'projector', 'fov': 30.0, 'scale': (3.0, 3.0, 3.0),
             'irradiance': {'type': 'checkerboard',
                            'color0': (1.0, 0.2, 0.2),
                            'color1': (0.2, 0.2, 1.0), 'uscale': 4.0,
                            'vscale': 4.0},
             'to_world': tr_mod.look_at((2.5, 2.5, -1.5), (0, 0.3, 0.3),
                                        (0, 1, 0))},
        ],
    }


def cbox_spot_directional(res_w: int = 64, res_h: int = 32, spp: int = 2,
                          integrator=None) -> dict:
    """The Cornell box lit by a ``spot`` inside and a ``directional``
    light through its open front, by default under the photon mapper:
    its light pass shoots from both (``emitter.sample_ray``)."""
    desc = cornell_box(spp=spp, res=res_w, light='none',
                       integrator=integrator or {
                           'type': 'photonmapper', 'max_depth': 6,
                           'global_photons': 20000})
    desc['sensor']['film']['height'] = res_h
    desc['emitters'] = [
        {'type': 'spot', 'position': (0.0, 0.9, -0.3),
         'direction': (0.1, -1.0, 0.4), 'intensity': (8.0, 7.0, 6.0),
         'cutoff_angle': 35.0},
        {'type': 'directional', 'direction': (0.25, -0.45, 1.0),
         'irradiance': (1.5, 1.5, 1.4)}]
    return desc


# --- spectral and polarized scenes -------------------------------------------

# the named conductor of the spectral scenes; ``write_conductor_spd``
# writes its tabulated complex IOR (a copper-like dispersion, values chosen)
SPECTRAL_CONDUCTOR = 'CuSynth'


def conductor_curves():
    """(wavelengths in nm, eta, k) of ``SPECTRAL_CONDUCTOR``, 300-900 nm
    every 10 nm."""
    wl = np.arange(300.0, 901.0, 10.0)
    t = (wl - 300.0) / 600.0
    return wl, 1.25 - t + 0.3 * np.sin(6.0 * t), 1.8 + 3.2 * t


def write_conductor_spd(directory: str, name: str = SPECTRAL_CONDUCTOR
                        ) -> str:
    """Writes ``<name>.eta.spd`` and ``<name>.k.spd`` into ``directory``
    (the directory ``MNT_IOR_DIR`` must name) and returns it."""
    os.makedirs(directory, exist_ok=True)
    wl, eta, k = conductor_curves()
    for which, vals in (('eta', eta), ('k', k)):
        with open(os.path.join(directory, f'{name}.{which}.spd'), 'w') as f:
            f.write(f'# {name} {which}: chosen values\n')
            f.writelines(f'{w:g} {v:.6f}\n' for w, v in zip(wl, vals))
    return directory


# the spectral scenes' two conductor blocks: (BSDF type, transform ops);
# they stand a thousandth above the floor, so that no face of theirs is
# coplanar with it (a hit there would be a tie broken by the last bit)
_SPECTRAL_BLOCKS = (
    ('conductor', [('scale', (0.3, 0.45, 0.3)), ('rotate', (0, 1, 0), 20),
                   ('translate', (-0.35, -0.549, 0.35))]),
    ('roughconductor', [('scale', (0.3, 0.3, 0.3)),
                        ('rotate', (0, 1, 0), -15),
                        ('translate', (0.4, -0.699, -0.2))]),
)
SPECTRAL_ALPHA = 0.15


def _ops_transform(ops, tr_mod):
    """``_tf``'s operations as a transform of ``tr_mod``, applied in
    order."""
    t = None
    for op in ops:
        m = (tr_mod.rotate(op[1], op[2]) if op[0] == 'rotate'
             else getattr(tr_mod, op[0])(op[1]))
        t = m if t is None else m @ t
    return t


def dress_spectral(desc: dict, tr_mod=tr,
                   conductor: str = SPECTRAL_CONDUCTOR) -> dict:
    """Turns spectral transport on in a ``cornell_box`` description and
    adds a ``conductor`` and a ``roughconductor`` block of the named
    material (its curves from ``MNT_IOR_DIR``)."""
    desc['spectral'] = True
    for kind, ops in _SPECTRAL_BLOCKS:
        bsdf = {'type': kind, 'material': conductor}
        if kind == 'roughconductor':
            bsdf['alpha'] = SPECTRAL_ALPHA
        desc['shapes'].append({'type': 'cube', 'bsdf': bsdf,
                               'to_world': _ops_transform(ops, tr_mod)})
    return desc


def cbox_spectral(directory: str, spp: int = 16, res: int = 512,
                  max_depth: int = 8) -> str:
    """Writes ``cbox_spectral.xml`` (``cbox_xml``'s box, its light the
    reference cbox.xml's SPD, with ``dress_spectral``'s two blocks), its
    OBJ meshes and the conductor's curves into ``directory``; returns the
    scene file's path. The file holds no spectral switch: the loader's
    description takes ``desc['spectral'] = True`` and the CLI
    ``--spectral``. ``MNT_IOR_DIR`` must name ``directory``."""
    write_conductor_spd(directory)
    lines = _xml(spp, res, res, max_depth,
                 _cbox_shapes(directory)).split('\n')
    blocks = []
    for kind, ops in _SPECTRAL_BLOCKS:
        blocks += ['    <shape type="cube">']
        blocks += _indent(_tf(ops), 8)
        blocks += [f'        <bsdf type="{kind}">',
                   f'            <string name="material" '
                   f'value="{SPECTRAL_CONDUCTOR}"/>']
        if kind == 'roughconductor':
            blocks += [f'            <float name="alpha" '
                       f'value="{SPECTRAL_ALPHA}"/>']
        blocks += ['        </bsdf>', '    </shape>']
    end = lines.index('</scene>')
    path = os.path.join(directory, 'cbox_spectral.xml')
    with open(path, 'w') as f:
        f.write('\n'.join(lines[:end] + blocks + lines[end:]))
    return path


# cbox_polarized's optical elements and materials (values chosen)
POLARIZED = {
    'polarizer': {'type': 'polarizer', 'theta': 30.0},
    'retarder': {'type': 'retarder', 'theta': 45.0, 'delta': 90.0},
    'circular': {'type': 'circular'},
    'glass': {'type': 'dielectric', 'int_ior': 1.5},
    'gold': {'type': 'conductor', 'eta': (0.143, 0.374, 1.442),
             'k': (3.983, 2.385, 1.603)},
    'rough_gold': {'type': 'roughconductor', 'alpha': 0.2,
                   'eta': (0.143, 0.374, 1.442), 'k': (3.983, 2.385, 1.603)},
    'pplastic': {'type': 'pplastic', 'diffuse_reflectance': (0.2, 0.3, 0.6),
                 'alpha': 0.06},
}


def dress_polarized(desc: dict, tr_mod=tr, conductor: str = None) -> dict:
    """Dresses a ``cornell_box`` description for polarized transport: a
    ``polarizer`` pane at 30 degrees, a quarter-wave ``retarder`` at 45
    degrees and a ``circular`` element between the camera and the box; a
    ``dielectric`` sphere, a ``conductor`` block and a ``roughconductor``
    block (of the named material ``conductor`` when given, else RGB
    gold); a ``pplastic`` back wall."""
    P = dict(POLARIZED)
    if conductor is not None:
        P['gold'] = {'type': 'conductor', 'material': conductor}
        P['rough_gold'] = {'type': 'roughconductor', 'alpha': 0.2,
                           'material': conductor}
    shapes = desc['shapes']
    shapes[2]['bsdf'] = P['pplastic']
    shapes += [
        {'type': 'rectangle', 'bsdf': P['polarizer'],
         'to_world': tr_mod.translate((-0.45, 0.15, -0.7))
         @ tr_mod.scale(0.32)},
        {'type': 'rectangle', 'bsdf': P['retarder'],
         'to_world': tr_mod.translate((0.45, 0.15, -0.7))
         @ tr_mod.scale(0.32)},
        {'type': 'rectangle', 'bsdf': P['circular'],
         'to_world': tr_mod.translate((0.0, 0.55, -0.8))
         @ tr_mod.scale(0.2)},
        {'type': 'sphere', 'center': (0.45, -0.68, 0.1), 'radius': 0.3,
         'bsdf': P['glass']},
        {'type': 'cube', 'bsdf': P['gold'],
         'to_world': tr_mod.translate((-0.45, -0.7, 0.4))
         @ tr_mod.rotate((0, 1, 0), 25) @ tr_mod.scale(0.28)},
        {'type': 'cube', 'bsdf': P['rough_gold'],
         'to_world': tr_mod.translate((0.05, -0.79, 0.65))
         @ tr_mod.rotate((0, 1, 0), -20) @ tr_mod.scale(0.2)},
    ]
    return desc


def stokes_integrator(component: int, max_depth: int = 8) -> dict:
    return {'type': 'stokes', 'component': component,
            'integrator': {'type': 'path', 'max_depth': max_depth}}


def with_component(meta, component: int):
    """A ``stokes`` meta with another ``component``."""
    props = tuple((k, component if k == 'component' else v)
                  for k, v in meta.integrator_props)
    return dataclasses.replace(meta, integrator_props=props)


def cbox_polarized(res: int = 512, spp: int = 16, component: int = 0,
                   spectral: bool = False, conductor: str = None,
                   max_depth: int = 8) -> dict:
    """``cornell_box`` under ``stokes`` (``component``) around ``path``
    with ``max_depth``, dressed by ``dress_polarized``; ``spectral`` turns
    the spectral polarized variant on."""
    desc = dress_polarized(cornell_box(
        spp=spp, res=res, integrator=stokes_integrator(component,
                                                       max_depth)),
        conductor=conductor)
    if spectral:
        desc['spectral'] = True
    return desc


def albedo_grid(grid_res: int = 8, seed: int = 0):
    """A seeded RGB albedo gridvolume over the medium cube's bbox."""
    r = np.random.default_rng(seed + 101)
    data = r.uniform(0.2, 0.9, size=(grid_res,) * 3 + (3,))
    h = MEDIUM_CUBE_SCALE
    return VolumeGrid(data=data.astype(np.float32),
                      bbox_min=np.full(3, -h, np.float32),
                      bbox_max=np.full(3, h, np.float32))


def albedo_grid_medium(grid_res: int = 16, seed: int = 0,
                       scale: float = 20.0) -> dict:
    """``hetvol_medium`` whose albedo is an ``albedo_grid``: the reference
    carries the grid and renders with albedo one."""
    med = hetvol_medium(grid_res=grid_res, seed=seed, scale=scale)
    med['albedo'] = {'type': 'gridvolume',
                     '_grid': albedo_grid(max(grid_res // 2, 2), seed)}
    return med


# --- measured materials -------------------------------------------------------
#
# The RGL database's measured files are not in the repository, so the
# measured scenes carry synthesized materials on the grids such a file
# holds: a GGX-flavoured NDF, VNDF, luminance and spectra (``.bsdf``) and a
# polarizing or depolarizing Mueller grid (``.pbsdf``), written with
# ``bsdf.measured.write_tensor_file`` and read back through the file
# reader. The warps' invariants (sample against pdf, eval = weight * pdf,
# invert of sample) hold for any positive fields.


def measured_fields(res: int = 32, n_theta: int = 8, alpha: float = 0.4,
                    n_phi: int = 0) -> dict:
    """The fields of a synthesized ``.bsdf`` file. ``n_phi`` 0: isotropic
    (phi_i holds -pi and pi); else ``n_phi`` azimuths over [-pi, 0], a
    measurement reduced by symmetry 2, whose VNDF and spectra vary with
    the incident azimuth."""
    theta_i = np.linspace(0.0, np.pi / 2 * 0.98, n_theta).astype(np.float32)
    if n_phi:
        phi_i = np.linspace(-np.pi, 0.0, n_phi).astype(np.float32)
    else:
        phi_i = np.array([-np.pi, np.pi], np.float32)
    wavelengths = np.array([420.0, 500.0, 580.0, 660.0], np.float32)
    xu = np.linspace(1e-3, 1.0, res)                     # theta2u coords
    yu = np.linspace(0.0, 1.0, res)                      # phi2u coords
    theta_m = xu ** 2 * (np.pi / 2)
    phi_m = (2.0 * yu - 1.0) * np.pi

    def ggx_d(t):
        c2 = np.cos(t) ** 2
        return alpha ** 2 / (np.pi * (c2 * (alpha ** 2 - 1) + 1) ** 2)

    ndf = np.tile(ggx_d(theta_m)[None, :], (res, 1)).astype(np.float32)
    sigma = np.tile((0.5 + 0.5 * np.cos(theta_m))[None, :],
                    (res, 1)).astype(np.float32)
    m_dirs = np.stack(np.broadcast_arrays(
        np.cos(phi_m)[:, None] * np.sin(theta_m)[None, :],
        np.sin(phi_m)[:, None] * np.sin(theta_m)[None, :],
        np.cos(theta_m)[None, :]), -1)
    jac = 2 * np.pi ** 2 * xu[None, :] * np.sin(theta_m)[None, :]
    n_p = len(phi_i)
    vndf = np.zeros((n_p, n_theta, res, res), np.float32)
    lum = np.zeros((n_p, n_theta, res, res), np.float32)
    spectra = np.zeros((n_p, n_theta, 4, res, res), np.float32)
    for pi_, ph in enumerate(phi_i):
        # an isotropic file's VNDF is relative to the incident azimuth
        ph = ph if n_phi else 0.0
        for ti, t in enumerate(theta_i):
            wi = np.array([np.sin(t) * np.cos(ph), np.sin(t) * np.sin(ph),
                           np.cos(t)])
            dvis = ggx_d(theta_m)[None, :] * np.maximum(m_dirs @ wi, 0.0) \
                + 1e-4
            vndf[pi_, ti] = (dvis * jac).astype(np.float32)
            lum[pi_, ti] = (0.4 + 0.6 * np.outer(1 - yu * (1 - yu),
                                                 np.cos(theta_m))).astype(
                np.float32)
        tint = 1.0 + (0.3 * np.cos(2.0 * ph) if n_phi else 0.0)
        for k in range(4):
            w = (0.3 + 0.7 * k / 3.0) * tint
            spectra[pi_, :, k] = w * (0.2 + np.cos(theta_m)[None, :])
    return {
        'theta_i': theta_i, 'phi_i': phi_i, 'wavelengths': wavelengths,
        'ndf': ndf, 'sigma': sigma, 'vndf': vndf, 'luminance': lum,
        'spectra': spectra,
        'description': np.frombuffer(b'synthetic ggx', np.uint8),
        'jacobian': np.array([1], np.uint8),
    }


def measured_pol_fields(kind: str = 'polarizing', Pd: int = 9, Td: int = 7,
                        Th: int = 6) -> dict:
    """The fields of a synthesized ``.pbsdf`` file on (phi_d, theta_d,
    theta_h, wavelength) grids: a depolarizing lobe (M00 alone) or an
    ideal linear polarizer scaled by a smooth magnitude."""
    phi_d = np.linspace(-np.pi, np.pi, Pd).astype(np.float32)
    theta_d = np.linspace(0.0, np.pi / 2, Td).astype(np.float32)
    theta_h = np.linspace(0.0, np.pi / 2, Th).astype(np.float32)
    wvls = np.array([450, 550, 650], np.uint16)
    W = wvls.shape[0]
    mag = (0.1 + 0.4 * np.cos(theta_h)[:, None]
           * (0.5 + 0.5 * np.arange(W)[None, :] / (W - 1)))  # (Th, W)
    M = np.zeros((Pd, Td, Th, W, 4, 4), np.float32)
    if kind == 'depolarizing':
        M[..., 0, 0] = mag[None, None]
    else:
        pol = 0.5 * np.array([[1, 1, 0, 0], [1, 1, 0, 0],
                              [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
        M[:] = mag[None, None, :, :, None, None] * pol
    return {'theta_h': theta_h.reshape(1, -1),
            'theta_d': theta_d.reshape(1, -1),
            'phi_d': phi_d.reshape(1, -1), 'wvls': wvls, 'M': M}


# cbox_measured's blocks: an isotropic material with the jacobian and an
# anisotropic one reduced by symmetry 2
MEASURED_FILES = {'iso.bsdf': dict(res=32, n_theta=8),
                  'aniso.bsdf': dict(res=32, n_theta=6, alpha=0.25,
                                     n_phi=5)}


def cbox_measured(directory: str, spp: int = 16, res: int = 512,
                  max_depth: int = 8) -> str:
    """Writes ``cbox_measured.xml`` with the box's OBJ walls and two
    synthesized ``.bsdf`` files (``MEASURED_FILES``) into ``directory``;
    returns its path: the Cornell box under ``path`` with ``max_depth``
    and two blocks in the measured materials."""
    from ..bsdf.measured import write_tensor_file
    os.makedirs(directory, exist_ok=True)
    for name, kw in MEASURED_FILES.items():
        write_tensor_file(os.path.join(directory, name),
                          measured_fields(**kw))
    lines = _xml(spp, res, res, max_depth,
                 _cbox_shapes(directory)).splitlines()[:-1]
    for fname, ops in (
            ('iso.bsdf', [('scale', (0.28, 0.6, 0.28)),
                          ('rotate', (0, 1, 0), 15),
                          ('translate', (-0.35, -0.4, 0.35))]),
            ('aniso.bsdf', [('scale', (0.28, 0.3, 0.28)),
                            ('rotate', (0, 1, 0), -18),
                            ('translate', (0.4, -0.7, -0.25))])):
        lines += ['    <shape type="cube">', *_indent(_tf(ops), 8),
                  '        <bsdf type="measured">',
                  f'            <string name="filename" value="{fname}"/>',
                  '        </bsdf>', '    </shape>']
    path = os.path.join(directory, 'cbox_measured.xml')
    with open(path, 'w') as f:
        f.write('\n'.join(lines + ['</scene>']) + '\n')
    return path


MEASURED_POL_SPHERE = {'center': (0.0, -0.55, 0.1), 'radius': 0.45}


def cbox_measured_polarized(directory: str, res: int = 512, spp: int = 16,
                            component: int = 1, max_depth: int = 8) -> dict:
    """``cornell_box`` under ``stokes`` (``component``) around ``path`` with
    ``max_depth`` and a sphere in a synthesized polarizing ``.pbsdf``
    material written into ``directory``."""
    from ..bsdf.measured import write_tensor_file
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, 'sphere.pbsdf')
    write_tensor_file(path, measured_pol_fields())
    desc = cornell_box(spp=spp, res=res,
                       integrator=stokes_integrator(component, max_depth))
    desc['shapes'].append({'type': 'sphere', **MEASURED_POL_SPHERE,
                           'bsdf': {'type': 'measured_polarized',
                                    'filename': path,
                                    'alpha_sample': 0.3}})
    return desc

"""Procedural scene descriptions: the port's copy of the reference's test
scenes (``tests/scenes.py``), built with the port's own transforms so a
program that must not import JAX (``chip_smoke.py``) can describe them;
``hetvol_box``, the Cornell box around a heterogeneous medium whose
density grid is made from a seed; and ``cbox_nlvrl``, a stand-in for the
thesis's headline configuration (cbox-nonlinear-homo-vrl)."""
from __future__ import annotations

import numpy as np

from ..core import transform as tr
from ..scene.vol_io import VolumeGrid

# the null cube that bounds a medium in the box, and its grid's bbox
MEDIUM_CUBE_SCALE = 0.95
# Gaussian blobs summed into hetvol_box's density
HETVOL_BLOBS = 8


def cornell_box(spp=4, res=32, integrator=None, light='area', medium=None):
    """An axis-aligned Cornell box built from rectangles, camera on -z;
    with ``medium``, a null cube (scale 0.95) holds it inside."""
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
            'emitter': {'type': 'area', 'radiance': (10.0, 10.0, 10.0)},
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
               scale=100.0):
    """The Cornell box around a heterogeneous medium in its null cube:
    the film, sigma_t scale and HG phase of the reference's hetvol scene,
    with a density grid made from ``seed`` (``hetvol_density``), rendered
    by ``volpath`` with max_depth 8."""
    desc = cornell_box(spp=spp, res=res_w,
                       integrator={'type': 'volpath', 'max_depth': 8},
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

"""Procedural scene descriptions: the port's copy of the reference's test
scenes (``tests/scenes.py``), built with the port's own transforms so a
program that must not import JAX (``chip_smoke.py``) can describe them."""
from __future__ import annotations

from ..core import transform as tr


def cornell_box(spp=4, res=32, integrator=None, light='area'):
    """An axis-aligned Cornell box built from rectangles, camera on -z."""
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

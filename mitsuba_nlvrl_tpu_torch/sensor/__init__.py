"""Sensors: perspective, thinlens, radiancemeter and irradiancemeter.

Port of ``mitsuba_nlvrl_tpu/sensor/__init__.py``: ``sample_ray`` maps film
samples in [0,1)^2 (and aperture samples) to world-space camera rays for
the whole wavefront at once, with fov applied along ``fov_axis``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.ray import Ray
from ..core.transform import Transform
from ..scene.types import SENSOR_TYPES


def build_sensor(props: dict, film_w: int, film_h: int
                 ) -> Tuple[int, Dict[str, np.ndarray]]:
    """(type code, numpy fields keyed like ``SensorData``)."""
    name = props.get('type', 'perspective')
    if name not in SENSOR_TYPES:
        raise ValueError(f"unknown sensor type '{name}'")
    to_world = props.get('to_world', Transform.identity())
    fov = float(props.get('fov', 34.0))
    fov_axis = props.get('fov_axis', 'x')
    aspect = film_w / film_h
    tan_half = np.tan(np.deg2rad(fov) / 2.0)
    # express as horizontal (x) tangent
    if fov_axis == 'x' or (fov_axis == 'smaller' and aspect >= 1.0) or \
       (fov_axis == 'larger' and aspect < 1.0):
        tan_x = tan_half
    elif fov_axis in ('y', 'smaller', 'larger'):
        tan_x = tan_half * aspect
    elif fov_axis == 'diagonal':
        diag = np.sqrt(1.0 + 1.0 / (aspect * aspect))
        tan_x = tan_half / diag
    else:
        raise ValueError(f"fov_axis {fov_axis}")
    tan_y = tan_x / aspect
    f32 = np.float32
    return SENSOR_TYPES[name], {
        'to_world.m': np.asarray(to_world.m, f32),
        'to_world.inv': np.asarray(to_world.inv, f32),
        'tan_fov_x': f32(tan_x), 'tan_fov_y': f32(tan_y),
        'near_clip': f32(props.get('near_clip', 1e-2)),
        'far_clip': f32(props.get('far_clip', 1e4)),
        'aperture_radius': f32(props.get('aperture_radius', 0.0)),
        'focus_distance': f32(props.get('focus_distance', 1.0))}


def sample_ray(scene, meta, pos_sample: torch.Tensor,
               aperture_sample: torch.Tensor) -> Tuple[Ray, torch.Tensor]:
    """pos_sample (N,2) in [0,1)^2 (0,0 = top-left pixel corner).

    Returns (world ray, importance weight (N,3): 1, or pi for the
    irradiance meter). Only the thin lens reads ``aperture_sample``; the
    render draws it for every sensor, as the reference does."""
    sen = scene.sensor
    stype = meta.sensor_type
    N = pos_sample.shape[0]
    dev = pos_sample.device
    if stype in (SENSOR_TYPES['perspective'], SENSOR_TYPES['thinlens']):
        # camera space: +z forward, +y up (image top = small sy -> +y)
        sx = pos_sample[:, 0]
        sy = pos_sample[:, 1]
        dx = (1.0 - 2.0 * sx) * sen.tan_fov_x
        dy = (1.0 - 2.0 * sy) * sen.tan_fov_y
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        if stype == SENSOR_TYPES['thinlens']:
            # the ray through the lens point toward the focus plane point
            p_lens2 = warp.square_to_uniform_disk_concentric(
                aperture_sample) * sen.aperture_radius
            o_cam = torch.cat([p_lens2, torch.zeros((N, 1), device=dev)],
                              dim=-1)
            d_cam = m.normalize(d_cam * sen.focus_distance - o_cam)
        else:
            d_cam = m.normalize(d_cam)
            o_cam = torch.zeros((N, 3), device=dev)
        o = sen.to_world.apply_point(o_cam)
        d = m.normalize(sen.to_world.apply_vector(d_cam))
        inv_z = 1.0 / d_cam[:, 2]
        ray = Ray(o=o, d=d, mint=sen.near_clip * inv_z,
                  maxt=sen.far_clip * inv_z)
        return ray, torch.ones((N, 3), device=dev)
    o = sen.to_world.apply_point(torch.zeros((N, 3), device=dev))
    if stype == SENSOR_TYPES['radiancemeter']:
        z = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(N, 3)
        d = m.normalize(sen.to_world.apply_vector(z))
        return Ray.make(o, d), torch.ones((N, 3), device=dev)
    if stype == SENSOR_TYPES['irradiancemeter']:
        # cosine-weighted hemisphere from the origin (a shape-attached
        # meter is approximated by the sensor frame, as in the reference)
        local = warp.square_to_cosine_hemisphere(pos_sample)
        d = m.normalize(sen.to_world.apply_vector(local))
        return Ray.make(o, d), torch.full((N, 3), m.Pi, device=dev)
    raise NotImplementedError(f"sensor type {stype}")

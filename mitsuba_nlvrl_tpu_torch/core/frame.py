"""Shading frame: local orthonormal basis around a normal.

Port of ``mitsuba_nlvrl_tpu/core/frame.py``: three unit vectors with
to_local/to_world, and the local-frame trigonometry of a direction (z the
normal).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


class Frame(NamedTuple):
    s: torch.Tensor  # tangent
    t: torch.Tensor  # bitangent
    n: torch.Tensor  # normal

    @staticmethod
    def from_normal(n: torch.Tensor) -> "Frame":
        s, t = m.coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack(
            [m.dot(v, self.s), m.dot(v, self.t), m.dot(v, self.n)], dim=-1)

    def to_world(self, v: torch.Tensor) -> torch.Tensor:
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])


def cos_theta(v):
    """cos of the angle to the normal, for v in local coordinates."""
    return v[..., 2]


def cos_theta_2(v):
    return m.sqr(v[..., 2])


def sin_theta_2(v):
    return m.clip(1.0 - cos_theta_2(v), min=0.0)


def sin_theta(v):
    return m.safe_sqrt(sin_theta_2(v))


def tan_theta(v):
    return m.safe_div(sin_theta(v), cos_theta(v))


def tan_theta_2(v):
    return m.safe_div(sin_theta_2(v), cos_theta_2(v))


def sin_phi(v):
    st = sin_theta(v)
    return torch.where(st == 0.0, 0.0,
                       m.clip(m.safe_div(v[..., 1], st), -1.0, 1.0))


def cos_phi(v):
    st = sin_theta(v)
    return torch.where(st == 0.0, 1.0,
                       m.clip(m.safe_div(v[..., 0], st), -1.0, 1.0))

"""4x4 affine/projective transforms.

Port of ``mitsuba_nlvrl_tpu/core/transform.py``. A ``Transform`` holds its
matrix and inverse as float32 numpy arrays while a scene is described and
built; ``to_torch`` moves it onto a device for the render. The ``apply_*``
forms work on either kind, written as broadcast multiply-adds in the
reference's order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    m: object      # (4, 4) float32 numpy array or torch tensor
    inv: object    # (4, 4) inverse matrix

    @staticmethod
    def identity() -> "Transform":
        e = np.eye(4, dtype=np.float32)
        return Transform(e, e.copy())

    @staticmethod
    def from_matrix(mat) -> "Transform":
        mat = np.asarray(mat, np.float64).reshape(4, 4)
        inv = np.linalg.inv(mat)
        return Transform(mat.astype(np.float32), inv.astype(np.float32))

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.inv @ self.inv)

    def inverse(self) -> "Transform":
        return Transform(self.inv, self.m)

    def to_torch(self, device) -> "Transform":
        return Transform(
            torch.as_tensor(np.asarray(self.m, np.float32), device=device),
            torch.as_tensor(np.asarray(self.inv, np.float32), device=device))

    def apply_point(self, p):
        M = self.m
        r = (p[..., 0:1] * M[:3, 0] + p[..., 1:2] * M[:3, 1]
             + p[..., 2:3] * M[:3, 2] + M[:3, 3])
        w = (p[..., 0] * M[3, 0] + p[..., 1] * M[3, 1]
             + p[..., 2] * M[3, 2] + M[3, 3])
        return r / w[..., None]

    def apply_vector(self, v):
        M = self.m
        return (v[..., 0:1] * M[:3, 0] + v[..., 1:2] * M[:3, 1]
                + v[..., 2:3] * M[:3, 2])

    def apply_normal(self, n):
        # normals transform by the inverse transpose
        Mi = self.inv
        return (n[..., 0:1] * Mi[0, :3] + n[..., 1:2] * Mi[1, :3]
                + n[..., 2:3] * Mi[2, :3])


def translate(t) -> Transform:
    mat = np.eye(4)
    mat[:3, 3] = np.asarray(t, np.float64)
    return Transform.from_matrix(mat)


def scale(s) -> Transform:
    s = np.broadcast_to(np.asarray(s, np.float64), (3,))
    mat = np.diag(np.concatenate([s, [1.0]]))
    return Transform.from_matrix(mat)


def rotate(axis, angle_deg: float) -> Transform:
    """Rotation about ``axis`` by ``angle_deg`` degrees (Rodrigues)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
    mat = np.eye(4)
    mat[:3, :3] = R
    return Transform.from_matrix(mat)


def look_at(origin, target, up) -> Transform:
    """Camera-to-world: columns are (left, new_up, dir, origin)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    direction = target - origin
    direction = direction / np.linalg.norm(direction)
    left = np.cross(up, direction)
    nl = np.linalg.norm(left)
    if nl < 1e-12:
        raise ValueError("look_at: up and viewing direction are parallel")
    left = left / nl
    new_up = np.cross(direction, left)
    mat = np.eye(4)
    mat[:3, 0] = left
    mat[:3, 1] = new_up
    mat[:3, 2] = direction
    mat[:3, 3] = origin
    return Transform.from_matrix(mat)


def perspective(fov_deg: float, near: float, far: float) -> Transform:
    """Perspective projection with fov along x (1/tan scale)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    mat = np.zeros((4, 4))
    mat[0, 0] = cot
    mat[1, 1] = cot
    mat[2, 2] = far * recip
    mat[2, 3] = -near * far * recip
    mat[3, 2] = 1.0
    return Transform.from_matrix(mat)

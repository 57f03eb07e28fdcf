"""4x4 affine/projective transforms.

Port of ``mitsuba_nlvrl_tpu/core/transform.py``. A ``Transform`` holds its
matrix and inverse as float32 numpy arrays while a scene is described and
built; ``to_torch`` moves it onto a device for the render. The ``apply_*``
forms work on either kind, written as broadcast multiply-adds in the
reference's order. ``AnimatedTransform`` interpolates keyframed
transforms on the host.
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


class AnimatedTransform:
    """A keyframed rigid and scale transform: ``append`` polar-decomposes
    each keyframe's matrix into a translation, a rotation quaternion and a
    3x3 scale-shear; ``eval(t)`` lerps the translation and the scale,
    slerps the rotation and composes T * R * S. Host side, in numpy: the
    wavefront is time-free, so an animated transform is resolved for each
    render."""

    def __init__(self, trafo: Transform = None):
        self.base = trafo if trafo is not None else Transform.identity()
        self.keyframes = []   # sorted (time, scale 3x3, quat wxyz, trans)

    @staticmethod
    def _polar(A: np.ndarray):
        """A = Q S by Higham's Newton iteration."""
        Q = A.copy()
        for _ in range(32):
            Qn = 0.5 * (Q + np.linalg.inv(Q).T)
            done = np.abs(Qn - Q).max() < 1e-12
            Q = Qn
            if done:
                break
        return Q, Q.T @ A

    @staticmethod
    def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
        t = np.trace(R)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                             (R[0, 2] - R[2, 0]) / s,
                             (R[1, 0] - R[0, 1]) / s])
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return q

    @staticmethod
    def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
        w, x, y, z = q / max(np.linalg.norm(q), 1e-30)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]])

    def append(self, time: float, trafo: Transform) -> "AnimatedTransform":
        M = np.asarray(trafo.m, np.float64)
        Q, S = self._polar(M[:3, :3])
        if np.linalg.det(Q) < 0:   # keep a proper rotation
            Q, S = -Q, -S
        self.keyframes.append((float(time), S, self._quat_from_matrix(Q),
                               M[:3, 3].copy()))
        self.keyframes.sort(key=lambda k: k[0])
        return self

    def eval(self, time: float) -> Transform:
        kf = self.keyframes
        if not kf:
            return self.base
        if time <= kf[0][0] or len(kf) == 1:
            return self._compose(*kf[0][1:])
        if time >= kf[-1][0]:
            return self._compose(*kf[-1][1:])
        hi = next(i for i, k in enumerate(kf) if k[0] >= time)
        (time0, S0, q0, tr0), (time1, S1, q1, tr1) = kf[hi - 1], kf[hi]
        t = (time - time0) / max(time1 - time0, 1e-30)
        S = (1 - t) * S0 + t * S1
        tr = (1 - t) * tr0 + t * tr1
        # quaternion slerp along the shortest arc
        d = float(np.dot(q0, q1))
        if d < 0:
            q1, d = -q1, -d
        if d > 1.0 - 1e-8:
            q = (1 - t) * q0 + t * q1
        else:
            th = np.arccos(np.clip(d, -1, 1))
            q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) \
                / np.sin(th)
        return self._compose(S, q, tr)

    def _compose(self, S, q, tr) -> Transform:
        M = np.eye(4)
        M[:3, :3] = self._quat_to_matrix(np.asarray(q)) @ S
        M[:3, 3] = tr
        return Transform.from_matrix(M)

"""Core math utilities on torch tensors.

Port of ``mitsuba_nlvrl_tpu/core/math.py``. Vectors carry a trailing
dimension of 3. Every expression keeps the reference's operation order so
that float32 rounding matches it step by step.

The reference's ``safe_sqrt``, ``safe_rsqrt``, ``safe_acos`` and
``safe_asin`` are ``jax.custom_jvp`` primitives whose derivatives are
clamped to zero at the singular points (``x > 1e-12`` for the roots,
``1 - x * x > 1e-12`` for the inverse sines): without the clamp, an
infinite derivative times a masked lane's zero cotangent is a NaN that
poisons every gradient. Here they are ``torch.autograd.Function``s with
the same clamping, taken only where a gradient is wanted; without one
they are the plain forward expressions.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# --- constants (match the reference package) ---------------------------------
Pi = 3.14159265358979323846
InvPi = 1.0 / Pi
InvTwoPi = 1.0 / (2.0 * Pi)
InvFourPi = 1.0 / (4.0 * Pi)
SqrtPi = 1.7724538509055160273
Epsilon = 1.1920929e-7 / 2  # float32 machine epsilon / 2
RayEpsilon = Epsilon * 1500.0
ShadowEpsilon = RayEpsilon * 10.0
Infinity = math.inf
OneMinusEpsilon = float(torch.tensor(1.0 - 1.1920929e-7, dtype=torch.float32))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def sqrt(x):
    """The correctly rounded square root on every device. On the CPU,
    torch's vectorised float32 sqrt is an ulp off near rounding midpoints
    on some hosts (an AVX-512 Xeon: 0.7% of lanes), where the reference's
    and the card's are correctly rounded; the square root of the float64
    value, rounded to float32, is the correctly rounded float32 result
    (float64 carries more than twice float32's precision)."""
    if x.dtype == torch.float32 and x.device.type == 'cpu':
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def fma(a, b: float, c):
    """``a * b + c`` rounded once (``b`` a constant), as the compiled
    reference computes it: LLVM contracts a product and a sum into one
    fused multiply-add, even at XLA's optimisation level 0 (ROADMAP C).
    The product of two float32 values is exact in float64, so the
    float64 sum rounds as the fused operation does (a double rounding
    differs only at exact float32 midpoints)."""
    b = float(np.float32(b))
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def rcp32(c) -> float:
    """float32(1 / c): the compiled reference divides by a constant as a
    product with its float32 reciprocal (ROADMAP C)."""
    return float(np.float32(1.0) / np.float32(c))


def _sqrt_fwd(x):
    return sqrt(torch.clamp(x, min=0.0))


def _rsqrt_fwd(x):
    return 1.0 / sqrt(torch.clamp(x, min=_F32_TINY))


def _acos_fwd(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def _asin_fwd(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def _clamped_rsqrt(s):
    """1 / sqrt(max(s, 1e-12)) where s > 1e-12, else 0."""
    return torch.where(s > 1e-12, 1.0 / torch.sqrt(torch.clamp(s, min=1e-12)),
                       0.0)


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _sqrt_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.where(x > 1e-12, 0.5 / torch.clamp(y, min=1e-12),
                               0.0)


class _SafeRsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _rsqrt_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.where(x > 1e-12,
                               -0.5 * y / torch.clamp(x, min=1e-12), 0.0)


class _SafeAcos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _acos_fwd(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * -_clamped_rsqrt(1.0 - x * x)


class _SafeAsin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _asin_fwd(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * _clamped_rsqrt(1.0 - x * x)


def _wants_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def safe_sqrt(x):
    """sqrt clamped to zero for negative inputs; its derivative is 0 at
    and below x = 1e-12."""
    return _SafeSqrt.apply(x) if _wants_grad(x) else _sqrt_fwd(x)


def safe_rsqrt(x):
    """1 / sqrt(x), both correctly rounded, so the card and the CPU agree
    to the bit (``torch.rsqrt`` is an approximation whose last bit
    differs between them, and a bend in a nonlinear medium at a total
    internal reflection turns on that bit). Its derivative is 0 at and
    below x = 1e-12."""
    return _SafeRsqrt.apply(x) if _wants_grad(x) else _rsqrt_fwd(x)


def safe_acos(x):
    """arccos of x clamped to [-1, 1]; its derivative is 0 where
    1 - x * x <= 1e-12."""
    return _SafeAcos.apply(x) if _wants_grad(x) else _acos_fwd(x)


def safe_asin(x):
    """arcsin of x clamped to [-1, 1]; its derivative is 0 where
    1 - x * x <= 1e-12."""
    return _SafeAsin.apply(x) if _wants_grad(x) else _asin_fwd(x)


@functools.lru_cache(maxsize=256)
def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d constant, made once a (value, dtype, device)."""
    return torch.full((), v, dtype=dtype, device=device)


def _bound(v, x):
    return v if isinstance(v, torch.Tensor) else _scalar(v, x.dtype,
                                                         x.device)


def clip(x, min=None, max=None):
    """``torch.clamp`` with the derivative of the reference's
    ``jnp.maximum``/``jnp.minimum``/``jnp.clip``: the same values, but
    under autograd the derivative at a tie (x equal to a bound) splits
    evenly between x and the bound, as JAX's does, where ``torch.clamp``
    gives x all of it. Ties are common where a ray starts on a medium's
    bounding box (a distance clamped at 0 is exactly 0)."""
    if not _wants_grad(x):
        return torch.clamp(x, min, max)
    if min is not None:
        x = torch.maximum(x, _bound(min, x))
    if max is not None:
        x = torch.minimum(x, _bound(max, x))
    return x


def safe_div(a, b, eps=1e-20):
    """a/b with 0 where |b| is (near-)zero."""
    denom_ok = torch.abs(b) > eps
    return torch.where(denom_ok, a / torch.where(denom_ok, b, 1.0), 0.0)


def rcp(x):
    return 1.0 / x


def safe_rcp(x, eps=1e-20):
    return safe_div(torch.ones_like(x), x, eps)


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def sign(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def mulsign(x, s):
    return torch.where(s >= 0.0, x, -x)


# --- vector ops (trailing axis = xyz) ---------------------------------------
# Sums over the last axis are written out left to right, ((x0 + x1) + x2),
# the order in which the reference's reduction adds them.

def _sum_last(v, keepdims: bool):
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s[..., None] if keepdims else s


def dot(a, b, keepdims: bool = False):
    return _sum_last(a * b, keepdims)


def abs_dot(a, b, keepdims: bool = False):
    return torch.abs(dot(a, b, keepdims))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def norm(v, keepdims: bool = False):
    return safe_sqrt(dot(v, v, keepdims))


def squared_norm(v, keepdims: bool = False):
    return dot(v, v, keepdims)


def normalize(v):
    return v * safe_rsqrt(squared_norm(v, keepdims=True))


def normalize_with_norm(v):
    n = norm(v, keepdims=True)
    return v * safe_rcp(n), n[..., 0]


def reflect(w, n):
    """Reflect direction ``w`` (pointing away from surface) about normal."""
    return 2.0 * dot(w, n, keepdims=True) * n - w


def refract_snell(wi, n, eta_rel):
    """Snell refraction of the propagation direction ``wi`` at a boundary
    whose normal ``n`` faces against it, with relative IOR
    ``eta_rel = n1 / n2`` (N,); returns (wo, tir_mask). The geometry of
    the nonlinear medium's cell-boundary bend."""
    eta = eta_rel[..., None]
    cos_i = clip(dot(n, wi, keepdims=True), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k[..., 0] < 0.0
    wo = eta * wi - (eta * cos_i + safe_sqrt(k)) * n
    return normalize(wo), tir


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit normal n (Duff et al.)."""
    s = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t0 = torch.cat(
        [mulsign(sqr(n[..., 0:1]) * a, s) + 1.0, mulsign(b, s),
         mulsign(-n[..., 0:1], s)], dim=-1)
    t1 = torch.cat([b, sqr(n[..., 1:2]) * a + s, -n[..., 1:2]], dim=-1)
    return t0, t1


def spherical_direction(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def linear_to_srgb(x):
    x = clip(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))

"""Measured polarized pBRDF (Baek et al. 2020).

Port of ``mitsuba_nlvrl_tpu/bsdf/measured_pol.py``: an isotropic
polarized BRDF stored as a 4-D grid of Mueller matrices over the
Rusinkiewicz parameterization (phi_d, theta_d, theta_h) and wavelength,
importance-sampled by a fixed cosine/GGX mixture and evaluated by
multilinear interpolation of the measured matrices (the whole (4, 4)
matrix in one 4-D interpolation), then rotated into the implicit Stokes
bases of the in/out directions. Channels read the RGB representative
wavelengths, or one wavelength for every channel where the row's
``wavelength`` is positive.

One ``MeasuredPolData`` a material lives in ``SceneData.measured_pol``;
the BSDF row holds (slot, alpha_sample, wavelength) in slots 0-2.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import frame as fr
from ..core import microfacet as mf
from ..core import warp as warp_mod
from ..core import mueller as mu
from .measured import read_tensor_file, RGB_WAVELENGTHS

# cosine-hemisphere weight of the sampling mixture
COSINE_WEIGHT = 0.1


class MeasuredPolData(NamedTuple):
    """The grid of one measured polarized material."""
    phi_d: torch.Tensor    # (Pd,) grid nodes, radians
    theta_d: torch.Tensor  # (Td,)
    theta_h: torch.Tensor  # (Th,)
    wvls: torch.Tensor     # (W,) wavelengths, nm
    table: torch.Tensor    # (Pd, Td, Th, W, 4, 4) Mueller matrices


def load(path: str, device=None, dtype=torch.float32) -> MeasuredPolData:
    """A ``.pbsdf`` tensor file -> MeasuredPolData."""
    return load_fields(read_tensor_file(path), device, dtype)


def load_fields(tf: dict, device=None, dtype=torch.float32
                ) -> MeasuredPolData:
    """Validate and build the grid from a parsed field dict: theta_h,
    theta_d, phi_d and wvls strictly increasing with two nodes or more, M
    of shape (Pd, Td, Th, W, 4, 4)."""
    axes = {k: np.asarray(tf[k], np.float32).reshape(-1)
            for k in ('phi_d', 'theta_d', 'theta_h', 'wvls')}
    table = np.asarray(tf['M'], np.float32)
    want = tuple(a.shape[0] for a in axes.values()) + (4, 4)
    if table.shape != want:
        raise ValueError(
            f"measured_polarized: M has shape {table.shape}, expected "
            f"{want} from the phi_d/theta_d/theta_h/wvls fields")
    for name, ax in axes.items():
        if ax.shape[0] < 2 or np.any(np.diff(ax) <= 0):
            raise ValueError(f"measured_polarized: {name} grid must be "
                             "strictly increasing with >= 2 nodes")

    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(dtype)
    return MeasuredPolData(table=t(table), **{k: t(a)
                                              for k, a in axes.items()})


# --- geometry --------------------------------------------------------------

def _phi(v):
    """Azimuth in [0, 2pi)."""
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0, p + 2.0 * m.Pi, p)


def _rot_z(v, angle):
    """Rotate v about +z by angle."""
    s, c = torch.sin(angle), torch.cos(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], -1)


def _axis(like, x, y, z):
    return torch.tensor([x, y, z], dtype=like.dtype, device=like.device)


def _safe_norm(v, fallback):
    n = m.norm(v)
    ok = n > 1e-8
    return torch.where(ok[..., None], v / m.clip(n, min=1e-12)[..., None],
                       fallback.expand(v.shape))


def _rusinkiewicz(i, o):
    """(phi_d, theta_h, theta_d) of the half-difference parameterization."""
    h = m.normalize(i + o)
    b = _safe_norm(m.cross(_axis(h, 0., 0., 1.).expand(h.shape), h),
                   _axis(h, 0., 1., 0.))
    t = _safe_norm(m.cross(b, h), _axis(h, 1., 0., 0.))
    td = m.safe_acos(m.dot(h, i))
    th = m.safe_acos(h[..., 2])
    i_prj = _safe_norm(i - m.dot(i, h)[..., None] * h, _axis(h, 1., 0., 0.))
    cos_pd = m.clip(m.dot(t, i_prj), -1.0, 1.0)
    sin_pd = m.clip(m.dot(b, i_prj), -1.0, 1.0)
    return torch.atan2(sin_pd, cos_pd), th, td


# --- 4-D multilinear Mueller interpolation -----------------------------------

def _axis_lerp(nodes, x):
    """Clamped segment index and weight on a strictly increasing grid."""
    idx = m.clip(torch.searchsorted(nodes, x.to(nodes.dtype).contiguous(),
                                    right=True) - 1, 0, nodes.shape[0] - 2)
    n0 = nodes[idx]
    n1 = nodes[idx + 1]
    return idx, m.clip((x - n0) / m.clip(n1 - n0, min=1e-12), 0.0, 1.0)


def eval_mueller(data: MeasuredPolData, pd, th, td, lam):
    """The measured Mueller matrix at (phi_d, theta_h, theta_d) and
    wavelengths ``lam`` (N, C) -> (N, C, 4, 4). A NaN cell zeroes the
    whole matrix; M00 is clamped to >= 0."""
    Td, Th, W = (data.theta_d.shape[0], data.theta_h.shape[0],
                 data.wvls.shape[0])
    tab = data.table.reshape(-1, 16)
    i0, w0 = _axis_lerp(data.phi_d, pd)                   # (N,)
    i1, w1 = _axis_lerp(data.theta_d, td)
    i2, w2 = _axis_lerp(data.theta_h, th)
    i3, w3 = _axis_lerp(data.wvls, lam)                   # (N, C)
    s0, s1, s2 = Td * Th * W, Th * W, W
    base = (i0 * s0 + i1 * s1 + i2 * s2)[:, None]         # (N, 1)
    acc = torch.zeros(lam.shape + (16,), dtype=w0.dtype, device=w0.device)
    for d0 in (0, 1):
        f0 = w0 if d0 else 1.0 - w0
        for d1 in (0, 1):
            f1 = w1 if d1 else 1.0 - w1
            for d2 in (0, 1):
                f2 = w2 if d2 else 1.0 - w2
                off = base + d0 * s0 + d1 * s1 + d2 * s2
                for d3 in (0, 1):
                    f3 = w3 if d3 else 1.0 - w3           # (N, C)
                    wgt = (f0 * f1 * f2)[:, None] * f3
                    acc = acc + wgt[..., None] * tab[off + i3 + d3]
    M = acc.reshape(lam.shape + (4, 4))
    bad = torch.isnan(M).any(-1).any(-1)
    M = torch.where(bad[..., None, None], 0.0, M)
    at00 = torch.zeros((4, 4), dtype=torch.bool, device=M.device)
    at00[0, 0] = True
    return torch.where(at00, m.clip(M[..., 0, 0], min=0.0)[..., None, None],
                       M)


def _lanes_lam(P, like):
    """Per-channel wavelengths: the row's fixed wavelength where positive,
    else the RGB representatives (N, 3)."""
    rep = torch.tensor(RGB_WAVELENGTHS, dtype=torch.float32,
                       device=like.device).expand(like.shape[:-1] + (3,))
    fixed = P[..., 2:3]
    return torch.where(fixed > 0, fixed.expand(rep.shape), rep)


# --- the unpolarized arms -----------------------------------------------------

def eval(data: MeasuredPolData, P, wi, wo, lam=None):
    """M00 * cos_theta_o per channel (M00 does not change under the Stokes
    basis rotations)."""
    cti, cto = fr.cos_theta(wi), fr.cos_theta(wo)
    act = (cti > 0) & (cto > 0)
    if lam is None:
        lam = _lanes_lam(P, wi)
    pd, th, td = _rusinkiewicz(wo, wi)
    M = eval_mueller(data, pd, th, td, lam)
    return torch.where(act[..., None], M[..., 0, 0] * cto[..., None], 0.0)


def pdf(P, wi, wo):
    """The cosine/GGX mixture's density."""
    a = m.clip(P[..., 1], min=1e-4)
    cti, cto = fr.cos_theta(wi), fr.cos_theta(wo)
    H = _safe_norm(wi + wo, _axis(wi, 0.0, 0.0, 1.0))
    pdf_d = warp_mod.square_to_cosine_hemisphere_pdf(wo)
    pdf_m = mf.vndf_pdf(wi, H, a, a) \
        / m.clip(4.0 * m.dot(wo, H), min=1e-9)
    p = COSINE_WEIGHT * pdf_d + (1.0 - COSINE_WEIGHT) * pdf_m
    return torch.where((cti > 0) & (cto > 0), p, 0.0)


def sample(data: MeasuredPolData, P, wi, u1, u2, lam=None):
    """wo from the mixture, weight = eval / pdf: (wo, pdf, weight)."""
    a = m.clip(P[..., 1], min=1e-4)
    wo_d = warp_mod.square_to_cosine_hemisphere(u2)
    h, _ = mf.sample_vndf(wi, u2, a, a)
    wo_m = 2.0 * m.dot(wi, h)[..., None] * h - wi
    wo = torch.where((u1 < COSINE_WEIGHT)[..., None], wo_d, wo_m)
    p = pdf(P, wi, wo)
    val = eval(data, P, wi, wo, lam)
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0) & (p > 0)
    weight = torch.where(act[..., None], val * m.safe_rcp(p)[..., None],
                         0.0)
    return wo, p, weight


# --- polarized eval -------------------------------------------------------------

def eval_mueller_world_local(data: MeasuredPolData, P, wi_loc, wo_loc,
                             mode_radiance: bool):
    """The polarized eval in the local shading frame: (N, 3, 4, 4) Mueller
    matrices (times cos_theta_o) whose in/out Stokes bases are the
    implicit ``stokes_basis`` of -wo_hat / wi_hat."""
    cti, cto = fr.cos_theta(wi_loc), fr.cos_theta(wo_loc)
    act = (cti > 0) & (cto > 0)
    wo_hat = wo_loc if mode_radiance else wi_loc
    wi_hat = wi_loc if mode_radiance else wo_loc

    # the standard frame: wi_hat's azimuth rotated onto the x axis
    phi_std = _phi(wi_hat)
    wo_std = _rot_z(wo_hat, -phi_std)
    wi_std = _rot_z(wi_hat, -phi_std)
    pd, th, td = _rusinkiewicz(wo_std, wi_std)
    M = eval_mueller(data, pd, th, td, _lanes_lam(P, wi_loc))

    # the Stokes reference axes in the plane of reflection
    y_axis = _axis(wo_std, 0.0, 1.0, 0.0)
    zo = -wo_std
    to = _safe_norm(m.cross(wo_std - wi_std, zo), y_axis)
    yo = _safe_norm(m.cross(to, zo), y_axis)
    xo = m.cross(yo, zo)
    zi = wi_std
    ti = _safe_norm(m.cross(wi_std - wo_std, zi), y_axis)
    yi = _safe_norm(m.cross(ti, zi), y_axis)
    xi = m.cross(yi, zi)

    # undo the phi_std rotation of the basis vectors, then rotate the
    # matrix into the implicit bases of -wo_hat / wi_hat
    xo_hat = _rot_z(xo, phi_std)
    xi_hat = _rot_z(xi, phi_std)
    M = mu.rotate_mueller_basis(
        M, (-wo_hat)[:, None], xo_hat[:, None],
        mu.stokes_basis(-wo_hat)[:, None],
        wi_hat[:, None], xi_hat[:, None],
        mu.stokes_basis(wi_hat)[:, None])
    out = M * cto[:, None, None, None]
    return torch.where(act[:, None, None, None], out, 0.0)

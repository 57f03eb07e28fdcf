"""Data-driven measured BSDF (Dupuy & Jakob 2018 adaptive parameterization).

Port of ``mitsuba_nlvrl_tpu/bsdf/measured.py`` and of its reader of the
tensor container that the RGL database's ``.bsdf`` files use: a
retro-reflectively parameterized microfacet warp. Sampling draws a
visible normal through two chained ``Marginal2D`` warps (luminance, then
VNDF) conditioned on the incident direction (phi_i, theta_i); evaluation
inverts the VNDF warp to fetch the measured spectra.

The spectra are read at fixed RGB representative wavelengths (612/549/465
nm) in the RGB pipeline, or at given hero wavelengths, as the reference
reads them. A material is a ``MeasuredData`` of warps in
``SceneData.measured`` (a tuple), its static facts (isotropic, jacobian,
reduction) a ``MeasuredMeta`` in ``SceneMeta.measured_meta``; the BSDF
row's slot 0 holds the material's index.
"""
from __future__ import annotations

import struct as _struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import math as m
from ..core import frame as fr
from ..core import distr2d

# the container's type codes
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# RGB-mode representative wavelengths (nm)
RGB_WAVELENGTHS = (612.0, 549.0, 465.0)


def read_tensor_file(path: str) -> dict:
    """Parse the tensor container: 12-byte 'tensor_file' magic, 2-byte
    version, u32 field count, then per field: u16 name length, name, u16
    ndim, u8 dtype, u64 offset, ndim x u64 shape."""
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:12] != b'tensor_file\x00':
        raise ValueError(f"{path}: not a tensor file")
    n_fields = _struct.unpack_from('<I', raw, 14)[0]
    pos = 18
    out = {}
    for _ in range(n_fields):
        (nlen,) = _struct.unpack_from('<H', raw, pos)
        pos += 2
        name = raw[pos:pos + nlen].decode()
        pos += nlen
        ndim, dtype, offset = _struct.unpack_from('<HBQ', raw, pos)
        pos += 11
        shape = _struct.unpack_from('<' + 'Q' * ndim, raw, pos)
        pos += 8 * ndim
        count = int(np.prod(shape)) if shape else 1
        out[name] = np.frombuffer(raw, np.dtype(_DTYPES[dtype]), count,
                                  offset).reshape(shape)
    return out


def write_tensor_file(path: str, fields: dict):
    """Inverse of ``read_tensor_file``."""
    header = bytearray(b'tensor_file\x00')
    header += bytes([1, 0])
    header += _struct.pack('<I', len(fields))
    offset = 18 + sum(2 + len(name.encode()) + 11 + 8 * np.ndim(arr)
                      for name, arr in fields.items())
    body = bytearray()
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        header += _struct.pack('<H', len(nb)) + nb
        header += _struct.pack('<HBQ', arr.ndim, _DTYPE_CODES[arr.dtype],
                               offset)
        header += _struct.pack('<' + 'Q' * arr.ndim, *arr.shape)
        body += arr.tobytes()
        offset += arr.nbytes
    with open(path, 'wb') as f:
        f.write(bytes(header) + bytes(body))


class MeasuredData(NamedTuple):
    """The warps of one measured material."""
    ndf: distr2d.Marginal2D        # unnormalized, eval-only
    sigma: distr2d.Marginal2D      # unnormalized, eval-only
    vndf: distr2d.Marginal2D       # conditioned on (phi_i, theta_i)
    luminance: distr2d.Marginal2D  # conditioned on (phi_i, theta_i)
    spectra: distr2d.Marginal2D    # on (phi_i, theta_i, wavelength)


class MeasuredMeta(NamedTuple):
    """Static facts (hashable, in ``SceneMeta.measured_meta``)."""
    isotropic: bool
    jacobian: bool
    reduction: int


def load(path: str, device=None, dtype=torch.float32):
    """A ``.bsdf`` tensor file -> (MeasuredData, MeasuredMeta)."""
    return load_fields(read_tensor_file(path), device, dtype)


def load_fields(tf: dict, device=None, dtype=torch.float32):
    """Build the warps from a parsed field dict."""
    theta_i = tf['theta_i'].astype(np.float32)
    phi_i = tf['phi_i'].astype(np.float32)
    wavelengths = tf['wavelengths'].astype(np.float32)
    isotropic = phi_i.shape[0] <= 2
    reduction = 1
    if not isotropic:
        reduction = int(round((2.0 * np.pi) / (phi_i[-1] - phi_i[0])))

    def warp(name, params=(), normalize=True):
        return distr2d.build(tf[name].astype(np.float32), params, normalize,
                             device, dtype)
    data = MeasuredData(
        ndf=warp('ndf', normalize=False),
        sigma=warp('sigma', normalize=False),
        vndf=warp('vndf', (phi_i, theta_i)),
        luminance=warp('luminance', (phi_i, theta_i)),
        spectra=warp('spectra', (phi_i, theta_i, wavelengths)))
    return data, MeasuredMeta(isotropic=isotropic,
                              jacobian=bool(tf['jacobian'].reshape(-1)[0]),
                              reduction=reduction)


# --- the parameterization ------------------------------------------------

def _u2theta(u):
    return m.sqr(u) * (m.Pi / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * m.Pi


def _theta2u(theta):
    return m.safe_sqrt(theta * (2.0 / m.Pi))


def _phi2u(phi):
    return (phi + m.Pi) * (0.5 / m.Pi)


def _elevation(d):
    """Numerically stable elevation."""
    dist = m.sqrt(m.sqr(d[..., 0]) + m.sqr(d[..., 1])
                  + m.sqr(d[..., 2] - 1.0))
    return 2.0 * m.safe_asin(0.5 * dist)


def _msn(a, b):
    """a * -sign(b) with sign(0) = +1."""
    return torch.where(b >= 0, -a, a)


def _reduce_wi(wi, reduction):
    """Fold the measurement's symmetry reductions."""
    if reduction < 2:
        return wi, None, None
    sy = wi[..., 1]
    sx = wi[..., 0] if reduction == 4 else sy
    wi = torch.stack([_msn(wi[..., 0], sx), _msn(wi[..., 1], sy),
                      wi[..., 2]], -1)
    return wi, sx, sy


def _spectra_rgb(data: MeasuredData, sample2d, phi_i, theta_i, lam=None):
    """The measured spectra at the warp position for each output channel
    (the RGB representatives, or the hero wavelengths ``lam``)."""
    if lam is None:
        lams = [torch.full(phi_i.shape, wl, dtype=torch.float32,
                           device=phi_i.device) for wl in RGB_WAVELENGTHS]
    else:
        lams = [lam[..., j] for j in range(lam.shape[-1])]
    return torch.stack([distr2d.eval(data.spectra, sample2d,
                                     (phi_i, theta_i, wl)) for wl in lams],
                       dim=-1)


def _jacobian_term(data, u_m, theta_i, phi_i):
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
    ndf_v = distr2d.eval(data.ndf, u_m)
    sigma_v = distr2d.eval(data.sigma, u_wi)
    return (ndf_v / (4.0 * m.clip(sigma_v, min=1e-12)))[..., None]


def sample(data: MeasuredData, mm: MeasuredMeta, wi, u2, lam=None):
    """Importance sample wo: (wo, pdf, weight (N, C))."""
    act = fr.cos_theta(wi) > 0
    wi_r, sx, sy = _reduce_wi(wi, mm.reduction)
    theta_i = _elevation(wi_r)
    phi_i = torch.atan2(wi_r[..., 1], wi_r[..., 0])
    params = (phi_i, theta_i)

    smp = torch.stack([u2[..., 1], u2[..., 0]], -1)
    smp, lum_pdf = distr2d.sample(data.luminance, smp, params)
    u_m, ndf_pdf = distr2d.sample(data.vndf, smp, params)

    phi_m = _u2phi(u_m[..., 1])
    theta_m = _u2theta(u_m[..., 0])
    if mm.isotropic:
        phi_m = phi_m + phi_i
    sin_t, cos_t = torch.sin(theta_m), torch.cos(theta_m)
    mvec = torch.stack([torch.cos(phi_m) * sin_t, torch.sin(phi_m) * sin_t,
                        cos_t], -1)
    jac = m.clip(2.0 * m.sqr(m.Pi) * u_m[..., 0] * sin_t, min=1e-6) \
        * 4.0 * m.dot(wi_r, mvec)
    wo = 2.0 * m.dot(wi_r, mvec, keepdims=True) * mvec - wi_r
    pdf = ndf_pdf * lum_pdf / jac

    spec = _spectra_rgb(data, smp, phi_i, theta_i, lam)
    if mm.jacobian:
        spec = spec * _jacobian_term(data, u_m, theta_i, phi_i)

    if mm.reduction >= 2:
        wo = torch.stack([_msn(wo[..., 0], sx), _msn(wo[..., 1], sy),
                          wo[..., 2]], -1)
    act = act & (fr.cos_theta(wo) > 0) & (pdf > 0)
    weight = torch.where(act[..., None],
                         spec * m.safe_rcp(pdf)[..., None], 0.0)
    return wo, torch.where(act, pdf, 0.0), weight


def _common_eval(mm: MeasuredMeta, wi, wo):
    wi_r, sx, sy = _reduce_wi(wi, mm.reduction)
    if mm.reduction >= 2:
        wo = torch.stack([_msn(wo[..., 0], sx), _msn(wo[..., 1], sy),
                          wo[..., 2]], -1)
    hv = m.normalize(wi_r + wo)
    theta_i = _elevation(wi_r)
    phi_i = torch.atan2(wi_r[..., 1], wi_r[..., 0])
    theta_m = _elevation(hv)
    phi_m = torch.atan2(hv[..., 1], hv[..., 0])
    u_phi = _phi2u(phi_m - phi_i if mm.isotropic else phi_m)
    u_m = torch.stack([_theta2u(theta_m), u_phi - torch.floor(u_phi)], -1)
    return wi_r, hv, theta_i, phi_i, u_m


def eval(data: MeasuredData, mm: MeasuredMeta, wi, wo, lam=None):
    """f(wi, wo) * cos_theta_o (N, C): the measured spectra include the
    cosine foreshortening."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    _, _, theta_i, phi_i, u_m = _common_eval(mm, wi, wo)
    smp, _ = distr2d.invert(data.vndf, u_m, (phi_i, theta_i))
    spec = _spectra_rgb(data, smp, phi_i, theta_i, lam)
    if mm.jacobian:
        spec = spec * _jacobian_term(data, u_m, theta_i, phi_i)
    return torch.where(act[..., None], spec, 0.0)


def pdf(data: MeasuredData, mm: MeasuredMeta, wi, wo):
    """Solid-angle density of ``sample``."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    wi_r, hv, theta_i, phi_i, u_m = _common_eval(mm, wi, wo)
    params = (phi_i, theta_i)
    smp, vndf_pdf = distr2d.invert(data.vndf, u_m, params)
    lum_pdf = distr2d.eval(data.luminance, smp, params)
    sin_m = m.sqrt(m.clip(m.sqr(hv[..., 0]) + m.sqr(hv[..., 1]), min=0.0))
    jac = m.clip(2.0 * m.sqr(m.Pi) * u_m[..., 0] * sin_m, min=1e-6) \
        * 4.0 * m.dot(wi_r, hv)
    out = vndf_pdf * lum_pdf / jac
    return torch.where(act & (out > 0), out, 0.0)

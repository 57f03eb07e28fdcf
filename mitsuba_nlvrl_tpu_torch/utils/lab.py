"""CIELab to sRGB as PIL converts an 8-bit ``LAB`` image to ``RGB``
(numpy, no PIL): PIL's ``Image.convert`` hands it to LittleCMS, from the
D50 Lab profile of ``ImageCms.createProfile('LAB')`` to the sRGB profile
of ``createProfile('sRGB')``, perceptual intent, 8 bits in and out. This
reproduces that transform as LittleCMS 2 computes it:

  * the pipeline Lab (V4 encoding) -> XYZ (``cmsLab2XYZ``, D50, over the
    1.15 fixed-point XYZ range) -> the inverse of the sRGB colorant
    matrix (Rec. 709 primaries, D65 adapted to D50 by Bradford, all in
    double) -> the inverse sRGB tone curve (parametric type 4, inverted
    analytically), each stage's output rounded to float32;
  * sampled, as its 8-bit optimisation does, on a 33^3 grid of 16-bit
    nodes (``_cmsQuickSaturateWord``: round half up through the 16.16
    magic-number floor);
  * evaluated by 16-bit tetrahedral interpolation (``TetrahedralInterp16``
    with its ``0x8001`` rounding), each 8-bit input widened by 257 and
    each 16-bit output narrowed as ``FROM_16_TO_8``.

Held to PIL on all 2^24 triples in ``tests/test_torch_tiff_rest.py``.
"""
from __future__ import annotations

import numpy as np

_GRID = 33
_MAX_XYZ = 1.0 + 32767.0 / 32768.0        # 1.15 fixed point's largest
_D50 = (0.9642, 1.0, 0.8249)
_SRGB_CURVE = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)
_table = None


def _inv3(a):
    """``_cmsMAT3inverse``: the cofactor formula, in double."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _srgb_to_xyz():
    """The sRGB profile's colorant matrix: ``_cmsBuildRGB2XYZtransferMatrix``
    of the Rec. 709 primaries and D65, adapted to D50 by Bradford
    (``_cmsAdaptMatrixToD50``)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inv3([[xr, xg, xb], [yr, yg, yb],
                         [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                [0.0389, -0.0685, 1.0296]]
    src = _apply(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _apply(bradford, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    return _mul(_mul(_inv3(bradford), _mul(cone, bradford)), m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: d + 0.5, clamped to 0..65535, floored
    through the 16.16 magic number as LittleCMS floors it."""
    d = d + 0.5
    out = np.where(d >= 65535.0, 65535, 0).astype(np.int64)
    mid = (d > 0) & (d < 65535.0)
    t = (d[mid] - 32767.0) + 68719476736.0 * 1.5
    low = t.view(np.int64) & 0xFFFFFFFF
    out[mid] = ((low - ((low & 0x80000000) << 1)) >> 16) + 32767
    return out


def _f_1(t):
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def _nodes() -> np.ndarray:
    """The (33, 33, 33, 3) 16-bit grid: the pipeline at each node."""
    q = np.floor(np.arange(_GRID) * 65535.0 / (_GRID - 1) + 0.5)
    f = [np.float32(v) / np.float32(65535.0)
         for v in np.meshgrid(q, q, q, indexing='ij')]
    y = (f[0].astype(np.float64) * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (f[1].astype(np.float64) * 255.0 - 128.0)
    z = y - 0.005 * (f[2].astype(np.float64) * 255.0 - 128.0)
    xyz = [(_f_1(v) * w / _MAX_XYZ).astype(np.float32).astype(np.float64)
           for v, w in zip((x, y, z), _D50)]
    inv = _inv3(_srgb_to_xyz())
    g, a, b, c, d = _SRGB_CURVE
    disc = (a * d + b) ** g
    out = []
    for row in inv:
        r = (((xyz[0] * (row[0] * _MAX_XYZ)) + xyz[1] * (row[1] * _MAX_XYZ))
             + xyz[2] * (row[2] * _MAX_XYZ)).astype(np.float32)
        r = r.astype(np.float64)
        with np.errstate(invalid='ignore'):
            hi = (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a
        v = np.where(r >= disc, hi, r / c).astype(np.float32)
        out.append(_saturate_word(v.astype(np.float64) * 65535.0))
    return np.stack(out, -1)


def _grid():
    global _table
    if _table is None:
        _table = _nodes()
    return _table


# for each of the six orders of the fractions: the cube corners the path
# passes after its first and second steps, and which fraction weighs each
# step (0: L, 1: a, 2: b)
_PATHS = (((1, 0, 0), (1, 1, 0), (0, 1, 2)), ((0, 0, 1), (1, 0, 1), (2, 0, 1)),
          ((1, 0, 0), (1, 0, 1), (0, 2, 1)), ((0, 1, 0), (1, 1, 0), (1, 0, 2)),
          ((0, 1, 0), (0, 1, 1), (1, 2, 0)), ((0, 0, 1), (0, 1, 1), (2, 1, 0)))


def _tetrahedral(t: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``TetrahedralInterp16`` of the grid ``t`` at the 16-bit inputs
    ``v`` (N, 3): (N, 3) 16-bit outputs."""
    fx = v * (_GRID - 1)
    fx = fx + (fx + 0x7FFF) // 0xFFFF             # _cmsToFixedDomain
    lo, r = fx >> 16, fx & 0xFFFF
    hi = np.where(v == 0xFFFF, lo, lo + 1)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    case = np.select(
        [(rx >= ry) & (ry >= rz), (rx >= ry) & (rz >= rx), rx >= ry,
         rx >= rz, ry >= rz], [0, 1, 2, 3, 4], 5)
    c0 = t[lo[:, 0], lo[:, 1], lo[:, 2]]
    c3 = t[hi[:, 0], hi[:, 1], hi[:, 2]]
    out = np.empty_like(c0)
    for k, (s1, s2, w) in enumerate(_PATHS):
        m = case == k
        if not m.any():
            continue
        corner = [np.where(np.array(s)[None, :] == 1, hi[m], lo[m])
                  for s in (s1, s2)]
        p1 = t[corner[0][:, 0], corner[0][:, 1], corner[0][:, 2]]
        p2 = t[corner[1][:, 0], corner[1][:, 1], corner[1][:, 2]]
        p0, p3, rm = c0[m], c3[m], r[m]
        rest = (p1 - p0) * rm[:, w[0], None] + (p2 - p1) * rm[:, w[1], None] \
            + (p3 - p2) * rm[:, w[2], None] + 0x8001
        out[m] = (p0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """PIL's ``LAB`` bytes (..., 3): L, then a* and b* offset by 128, as
    PIL holds them) as its ``convert('RGB')`` makes them: (..., 3)
    uint8."""
    t = _grid()
    flat = np.asarray(lab, np.uint8).reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, len(flat), chunk):
        v16 = flat[s:s + chunk].astype(np.int64) * 257
        o = _tetrahedral(t, v16)
        out[s:s + chunk] = (o * 65281 + 8388608) >> 24    # FROM_16_TO_8
    return out.reshape(np.shape(lab))

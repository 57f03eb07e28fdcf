"""Pearson chi-square goodness-of-fit test for sampling routines.

Port of ``mitsuba_nlvrl_tpu/testing/chi2.py``: histogram the output of
``sample_func`` over a domain, integrate ``pdf_func`` over the same cells
numerically, pool the cells of low expected count, and compare with a
chi-square test. It holds warps, BSDF sampling and phase functions to
their pdfs. The tables are made on the host in numpy; ``sample_func``
takes a (count, dim) float32 tensor of the reference harness's uniforms
(``jax.random.uniform(PRNGKey(seed), (count, dim))``, drawn by
``core/rng``) and ``pdf_func`` a float32 tensor of directions or points,
both on the CPU.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import rng


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SphericalDomain:
    """Directions on S^2 mapped to (cos_theta, phi): a constant
    Jacobian."""

    aspect = 2.0

    def bounds(self):
        return np.array([[-1.0, 1.0], [-np.pi, np.pi]])

    def map_forward(self, d):
        d = _np(d)
        return np.stack([d[..., 2], np.arctan2(d[..., 1], d[..., 0])],
                        axis=-1)

    def map_backward(self, p):
        cos_t = p[..., 0]
        sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t * cos_t))
        phi = p[..., 1]
        return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t],
                        axis=-1)


class PlanarDomain:
    """An axis-aligned 2D region."""

    aspect = 1.0

    def __init__(self, bounds=None):
        self._b = np.asarray(bounds if bounds is not None
                             else [[-1.0, 1.0], [-1.0, 1.0]])

    def bounds(self):
        return self._b

    def map_forward(self, p):
        return _np(p)[..., :2]

    def map_backward(self, p):
        return p


class ChiSquareTest:
    def __init__(self, domain, sample_func: Callable, pdf_func: Callable,
                 sample_dim: int = 2, sample_count: int = 1_000_000,
                 res: int = 64, ires: int = 8, seed: int = 0):
        self.domain = domain
        self.sample_func = sample_func
        self.pdf_func = pdf_func
        self.sample_dim = sample_dim
        self.sample_count = int(sample_count)
        self.res = (res, int(res * getattr(domain, 'aspect', 1.0)))
        self.ires = ires
        self.seed = seed
        self.messages = ''

    def samples(self) -> torch.Tensor:
        """The harness's uniforms: (sample_count, sample_dim) float32."""
        return rng.uniform(rng.PRNGKey(self.seed),
                           (self.sample_count, self.sample_dim))

    def tabulate_histogram(self):
        p = self.domain.map_forward(self.sample_func(self.samples()))
        # a sample_func marks rejected samples NaN; they are dropped, and
        # the pdf then integrates to the acceptance probability
        p = p[np.isfinite(p).all(axis=-1)]
        b = self.domain.bounds()
        self.histogram, _, _ = np.histogram2d(
            p[:, 0], p[:, 1], bins=self.res,
            range=[tuple(b[0]), tuple(b[1])])
        return self.histogram

    def tabulate_pdf(self):
        b = self.domain.bounds()
        r0, r1 = self.res
        i = self.ires
        # the midpoint rule on an ires x ires subgrid a cell
        e0 = np.linspace(b[0][0], b[0][1], r0 * i + 1)
        e1 = np.linspace(b[1][0], b[1][1], r1 * i + 1)
        c0 = 0.5 * (e0[:-1] + e0[1:])
        c1 = 0.5 * (e1[:-1] + e1[1:])
        g0, g1 = np.meshgrid(c0, c1, indexing='ij')
        d = self.domain.map_backward(np.stack([g0.ravel(), g1.ravel()],
                                              axis=-1))
        pdf = _np(self.pdf_func(torch.as_tensor(d, dtype=torch.float32)))
        pdf = np.broadcast_to(pdf, d.shape[:-1])
        cell_area = ((b[0][1] - b[0][0]) / (r0 * i)
                     * (b[1][1] - b[1][0]) / (r1 * i))
        pdf = pdf.reshape(r0, i, r1, i).mean(axis=(1, 3)) \
            * cell_area * i * i
        self.pdf = pdf * self.sample_count
        return self.pdf

    def run(self, significance_level: float = 0.01,
            min_expected: float = 5.0) -> bool:
        self.tabulate_histogram()
        self.tabulate_pdf()
        obs = self.histogram.ravel()
        exp = self.pdf.ravel()
        # pool the cells of low expected count (Pearson's practice)
        order = np.argsort(exp)
        obs, exp = obs[order], exp[order]
        pooled_obs, pooled_exp = [], []
        acc_o = acc_e = 0.0
        for o, e in zip(obs, exp):
            acc_o += o
            acc_e += e
            if acc_e >= min_expected:
                pooled_obs.append(acc_o)
                pooled_exp.append(acc_e)
                acc_o = acc_e = 0.0
        if acc_e > 0 and pooled_exp:
            pooled_obs[-1] += acc_o
            pooled_exp[-1] += acc_e
        po = np.asarray(pooled_obs)
        pe = np.asarray(pooled_exp)
        dof = len(po) - 1
        if dof <= 0:
            self.messages = 'chi2: not enough cells'
            return False
        stat = float(np.sum((po - pe) ** 2 / np.maximum(pe, 1e-9)))
        # p-value = Q(dof/2, stat/2), the regularized upper incomplete gamma
        p_value = float(torch.special.gammaincc(
            torch.tensor(dof / 2.0, dtype=torch.float64),
            torch.tensor(stat / 2.0, dtype=torch.float64)))
        self.p_value = p_value
        self.messages = (f'chi2 stat={stat:.2f} dof={dof} '
                         f'p-value={p_value:.4f} '
                         f'(significance {significance_level})')
        return p_value >= significance_level

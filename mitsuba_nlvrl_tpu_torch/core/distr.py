"""1D distributions for importance sampling.

Port of ``mitsuba_nlvrl_tpu/core/distr.py``: a discrete distribution, a
piecewise-linear density on a regular grid and one on an irregular grid.
The tables are built once; sampling is a vectorized ``searchsorted``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import math as m


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cell_index(cdf, x, n_cells: int) -> torch.Tensor:
    """The cell whose cumulative integral first exceeds x (clamped)."""
    return m.clip(torch.searchsorted(cdf, x.contiguous(), right=True),
                       0, n_cells - 1)


def _invert_linear_cell(rem, p0, p1, dx):
    """Position t in [0, 1] inside a cell whose density goes linearly from
    p0 to p1 over width dx, where the mass ``rem`` lies before t."""
    a = 0.5 * (p1 - p0) * dx
    b = p0 * dx
    disc = m.safe_sqrt(b * b + 4.0 * a * rem)
    t = torch.where(torch.abs(a) > 1e-12 * torch.abs(b),
                    m.safe_div(2.0 * rem, b + disc), m.safe_div(rem, b))
    return m.clip(t, 0.0, 1.0)


class DiscreteDistribution(NamedTuple):
    pmf: torch.Tensor       # (n,) unnormalized probabilities
    cdf: torch.Tensor       # (n,) inclusive cumulative sum
    total: torch.Tensor     # () sum

    @staticmethod
    def make(pmf, device=None) -> "DiscreteDistribution":
        pmf = _as_f32(pmf, device)
        cdf = torch.cumsum(pmf, 0)
        return DiscreteDistribution(pmf=pmf, cdf=cdf, total=cdf[-1])

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF sample; u in [0,1) -> index (int32)."""
        return _cell_index(self.cdf, u * self.total,
                           self.pmf.shape[0]).to(torch.int32)

    def sample_reuse(self, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample an index and rescale u to [0,1) within the chosen bin."""
        idx = self.sample(u)
        il = idx.long()
        lo = torch.where(idx > 0, self.cdf[m.clip(il - 1, min=0)], 0.0)
        u_re = m.clip(m.safe_div(u * self.total - lo, self.pmf[il]),
                           0.0, m.OneMinusEpsilon)
        return idx, u_re

    def eval_pmf_normalized(self, idx: torch.Tensor) -> torch.Tensor:
        return m.safe_div(self.pmf[idx.long()], self.total)


class ContinuousDistribution(NamedTuple):
    """Piecewise-linear density on [range_min, range_max]."""
    pdf: torch.Tensor        # (n,) density values at nodes
    cdf: torch.Tensor        # (n-1,) integral up to each cell end
    range_min: torch.Tensor
    range_max: torch.Tensor
    integral: torch.Tensor

    @staticmethod
    def make(pdf, range_min, range_max, device=None
             ) -> "ContinuousDistribution":
        pdf = _as_f32(pdf, device)
        n = pdf.shape[0]
        dx = (range_max - range_min) / (n - 1)
        cdf = torch.cumsum(0.5 * (pdf[:-1] + pdf[1:]) * dx, 0)
        return ContinuousDistribution(
            pdf=pdf, cdf=cdf, range_min=_as_f32(range_min, device),
            range_max=_as_f32(range_max, device), integral=cdf[-1])

    def _dx(self):
        return (self.range_max - self.range_min) / (self.pdf.shape[0] - 1)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF sample of the piecewise-linear density -> x."""
        n = self.pdf.shape[0]
        dx = self._dx()
        x = u * self.integral
        idx = _cell_index(self.cdf, x, n - 1)
        lo = torch.where(idx > 0, self.cdf[m.clip(idx - 1, min=0)], 0.0)
        t = _invert_linear_cell(x - lo, self.pdf[idx], self.pdf[idx + 1], dx)
        return self.range_min + (idx + t) * dx

    def eval_pdf(self, x: torch.Tensor) -> torch.Tensor:
        n = self.pdf.shape[0]
        f = m.clip((x - self.range_min) / self._dx(), 0.0,
                        n - 1 - 1e-6)
        idx = f.to(torch.int32)
        t = f - idx
        il = idx.long()
        inside = (x >= self.range_min) & (x <= self.range_max)
        return torch.where(inside, m.lerp(self.pdf[il],
                                          self.pdf[m.clip(il + 1,
                                                               max=n - 1)],
                                          t), 0.0)


class IrregularContinuousDistribution(NamedTuple):
    """Piecewise-linear density on an increasing node grid (spectra
    tabulated at non-uniform wavelengths)."""
    nodes: torch.Tensor      # (n,) strictly increasing positions
    pdf: torch.Tensor        # (n,) density values at nodes
    cdf: torch.Tensor        # (n-1,) integral up to each cell end
    integral: torch.Tensor

    @staticmethod
    def make(nodes, pdf, device=None) -> "IrregularContinuousDistribution":
        nodes = _as_f32(nodes, device)
        pdf = _as_f32(pdf, device)
        dx = nodes[1:] - nodes[:-1]
        cdf = torch.cumsum(0.5 * (pdf[:-1] + pdf[1:]) * dx, 0)
        return IrregularContinuousDistribution(nodes=nodes, pdf=pdf,
                                               cdf=cdf, integral=cdf[-1])

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF sample -> positions in [nodes[0], nodes[-1]]."""
        n = self.pdf.shape[0]
        x = u * self.integral
        idx = _cell_index(self.cdf, x, n - 1)
        lo = torch.where(idx > 0, self.cdf[m.clip(idx - 1, min=0)], 0.0)
        dx = self.nodes[idx + 1] - self.nodes[idx]
        t = _invert_linear_cell(x - lo, self.pdf[idx], self.pdf[idx + 1], dx)
        return self.nodes[idx] + t * dx

    def eval_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Linear interpolation of the density."""
        n = self.pdf.shape[0]
        idx = m.clip(torch.searchsorted(self.nodes, x.contiguous(),
                                             right=True) - 1, 0, n - 2)
        x0 = self.nodes[idx]
        x1 = self.nodes[idx + 1]
        t = m.safe_div(x - x0, x1 - x0)
        inside = (x >= self.nodes[0]) & (x <= self.nodes[-1])
        return torch.where(inside, m.lerp(self.pdf[idx], self.pdf[idx + 1],
                                          m.clip(t, 0.0, 1.0)), 0.0)

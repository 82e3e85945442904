"""Distribution models of the uniformization trick (paper Sec. 3.1).

  * ``GaussianModel``  — closed-form CDF ``Phi`` / quantile ``Phi^{-1}`` with
    per-tensor or per-channel (mu, sigma): the paper's choice.
  * ``EmpiricalModel`` — sorted-sample empirical CDF / quantile (beyond the
    paper; exact for any distribution, O(log n) per lookup).

``cdf`` uniformizes (U = F(W)) and ``quantile`` deuniformizes (W = F^{-1}(U)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_EPS = 1e-6


# rows of the first stage of ``_sum_fixed_order``.  torch reduces a tensor
# to many values by giving each thread whole outputs, and splits a reduction
# to one value among threads only from tens of thousands of elements on, far
# above this; so neither stage's order depends on the number of threads
_SUM_ROWS = 1024


def _sum_fixed_order(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element of f32 ``x``, in an order that does not depend
    on the number of CPU threads: each of ``_SUM_ROWS`` rows (zero-padded
    at the end) is summed whole by one thread, then the row sums in one
    pass."""
    flat = x.reshape(-1)
    cols = -(-flat.numel() // _SUM_ROWS)
    if cols * _SUM_ROWS != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, cols * _SUM_ROWS
                                              - flat.numel()))
    return flat.reshape(_SUM_ROWS, cols).sum(dim=1).sum()


def _full_mean_std(w: torch.Tensor):
    """Mean and population deviation of every element of ``w`` (f32, in a
    fixed order; returned in w's dtype, shaped (1,) * w.ndim)."""
    x = w.to(torch.float32)
    n = x.numel()
    mu = _sum_fixed_order(x) / n
    var = _sum_fixed_order(torch.square(x - mu)) / n
    shape = (1,) * w.ndim
    return (mu.reshape(shape).to(w.dtype),
            torch.sqrt(var).reshape(shape).to(w.dtype))


def _axes_excluding(ndim: int, channel_axis: Optional[int]) -> Tuple[int, ...]:
    if channel_axis is None:
        return tuple(range(ndim))
    channel_axis = channel_axis % ndim
    return tuple(a for a in range(ndim) if a != channel_axis)


@dataclasses.dataclass(frozen=True)
class GaussianModel:
    """Gaussian weight model  W ~ N(mu, sigma^2).

    ``mu``/``sigma`` broadcast against the weight tensor."""

    mu: torch.Tensor
    sigma: torch.Tensor

    @staticmethod
    def fit(w: torch.Tensor,
            channel_axis: Optional[int] = None) -> "GaussianModel":
        """Estimate (mu, sigma); sigma is the population deviation."""
        axes = _axes_excluding(w.ndim, channel_axis)
        if len(axes) == w.ndim:
            mu, sigma = _full_mean_std(w)
        else:
            # one value a kept index, each reduced whole by one thread
            mu = torch.mean(w, dim=axes, keepdim=True)
            sigma = torch.std(w, dim=axes, correction=0, keepdim=True)
        sigma = torch.clamp(sigma, min=1e-8)
        return GaussianModel(mu=mu.detach(), sigma=sigma.detach())

    def cdf(self, w: torch.Tensor) -> torch.Tensor:
        """Uniformize:  u = Phi((w - mu)/sigma) in (0, 1), f32 internally."""
        z = (w.to(torch.float32) - self.mu) / self.sigma
        u = torch.special.ndtr(z.to(torch.float32))
        return torch.clamp(u, _EPS, 1.0 - _EPS)

    def quantile(self, u: torch.Tensor) -> torch.Tensor:
        """Deuniformize:  w = mu + sigma * Phi^{-1}(u)."""
        u = torch.clamp(u, _EPS, 1.0 - _EPS)
        return self.mu + self.sigma * torch.special.ndtri(u)

    def level_values(self, k: int) -> torch.Tensor:
        """The k representation levels q_i = F^{-1}((i+1/2)/k); shape
        ``(k,) + broadcast(mu, sigma).shape``."""
        centers = (torch.arange(k, dtype=torch.float32,
                                device=self.mu.device) + 0.5) / k
        base = torch.special.ndtri(centers)
        nd = len(torch.broadcast_shapes(self.mu.shape, self.sigma.shape))
        return self.mu + self.sigma * base.reshape((k,) + (1,) * nd)


@dataclasses.dataclass(frozen=True)
class EmpiricalModel:
    """Empirical CDF / quantile from a sorted reference sample.

    ``sorted_ref`` is a 1-D ascending f32 sample of the weight population.
    ``cdf`` is the mid-rank empirical CDF, ``quantile`` its inverse by
    linear interpolation between order statistics.
    """

    sorted_ref: torch.Tensor  # (n,) sorted ascending

    @staticmethod
    def fit(w: torch.Tensor, max_samples: int = 65536) -> "EmpiricalModel":
        """Sort ``w`` (flattened) or, above ``max_samples`` elements, the
        deterministic strided subsample ``flat[:stride * max_samples:
        stride]`` with ``stride = n // max_samples`` (quantiles stay
        stable)."""
        flat = w.reshape(-1)
        n = flat.shape[0]
        if n > max_samples:
            stride = n // max_samples
            flat = flat[: stride * max_samples: stride]
        ref = torch.sort(flat.detach().to(torch.float32)).values
        return EmpiricalModel(sorted_ref=ref)

    def cdf(self, w: torch.Tensor) -> torch.Tensor:
        """u = (#{ref <= w} - 1/2) / n, clipped to [eps, 1 - eps].  The
        division is by a tensor on the sample's device: PyTorch's CUDA
        kernel multiplies by the reciprocal of a host scalar, which rounds
        otherwise than the division the CPU (and the reference) takes."""
        ref = self.sorted_ref
        n = torch.tensor(float(ref.shape[0]), device=ref.device)
        idx = torch.searchsorted(ref, w.to(torch.float32).contiguous(),
                                 right=True)
        u = (idx.to(torch.float32) - 0.5) / n
        return torch.clamp(u, _EPS, 1.0 - _EPS)

    def quantile(self, u: torch.Tensor) -> torch.Tensor:
        ref = self.sorted_ref
        n = ref.shape[0]
        u = torch.clamp(u, _EPS, 1.0 - _EPS)
        pos = u * n - 0.5
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        frac = torch.clamp(pos - lo.to(torch.float32), 0.0, 1.0)
        return (1.0 - frac) * ref[lo] + frac * ref[hi]

    def level_values(self, k: int) -> torch.Tensor:
        """The k levels F^{-1}((i + 1/2) / k), shape (k,)."""
        centers = (torch.arange(k, dtype=torch.float32,
                                device=self.sorted_ref.device) + 0.5) / k
        return self.quantile(centers)


def fit_model(w: torch.Tensor, kind: str = "gaussian",
              channel_axis: Optional[int] = None):
    """Factory: ``kind`` in {"gaussian", "empirical"}."""
    if kind == "gaussian":
        return GaussianModel.fit(w, channel_axis=channel_axis)
    if kind == "empirical":
        return EmpiricalModel.fit(w)
    raise ValueError(f"unknown distribution model: {kind!r}")

"""Distribution model of the uniformization trick (Gaussian, paper Sec. 3.1).

``cdf`` uniformizes (U = F(W)) and ``quantile`` deuniformizes (W = F^{-1}(U)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_EPS = 1e-6


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

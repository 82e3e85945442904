"""Uniform noise injection — the UNIQ training-time transform (paper Sec. 3.2).

At training, instead of the non-differentiable quantizer, a weight ``w`` is
passed through

    w_hat = F^{-1}( clip( F(w) + e ) ),    e ~ U[-1/(2k), +1/(2k)]

which by the uniformization trick emulates the k-quantile quantizer's error
with bin-independent uniform noise.  The transform is smooth, so gradients
flow through it (the statistics are detached constants of the step).

Only the k-quantile quantizer is ported.  The reference's noise injection
for the uniform and k-means quantizers (the paper's Table-3 ablation) raises
``NotImplementedError`` here.  The training path itself goes through the
fused kernel (``core/uniq.py:transform_param``); this module is the
unfused formulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distributions import GaussianModel


def uniform_noise(gen: torch.Generator, shape, k: int,
                  dtype=torch.float32) -> torch.Tensor:
    """e ~ U[-1/(2k), +1/(2k)] — the quantization-error surrogate, drawn on
    the generator's device."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=dtype)
    return u * (1.0 / k) - 0.5 / k


def _fit(w: torch.Tensor, dist: str, channel_axis: Optional[int]):
    if dist == "gaussian":
        return GaussianModel.fit(w, channel_axis=channel_axis)
    if dist == "empirical":
        raise NotImplementedError(
            "dist='empirical' in training (noise injection through the "
            "EmpiricalModel) is not ported yet")
    raise ValueError(f"unknown distribution model: {dist!r}")


def inject_kquantile(w: torch.Tensor, gen: torch.Generator, k: int,
                     model=None, channel_axis: Optional[int] = None,
                     dist: str = "gaussian") -> torch.Tensor:
    """UNIQ forward transform for the k-quantile quantizer: one CDF, one
    uniform draw, one quantile.  Noise amplitude 1/(2k) for every bin."""
    if model is None:
        model = _fit(w, dist, channel_axis)
    u = model.cdf(w)
    e = uniform_noise(gen, w.shape, k, dtype=u.dtype)
    u_hat = torch.clamp(u + e, 0.5 / k * 1e-3, 1.0 - 0.5 / k * 1e-3)
    return model.quantile(u_hat).to(w.dtype)


def inject(w: torch.Tensor, gen: torch.Generator, k: int,
           method: str = "kquantile", channel_axis: Optional[int] = None,
           dist: str = "gaussian") -> torch.Tensor:
    """Dispatch over quantizer family (training-time noise injection)."""
    if method == "kquantile":
        return inject_kquantile(w, gen, k, channel_axis=channel_axis,
                                dist=dist)
    if method in ("uniform", "kmeans"):
        raise NotImplementedError(
            f"noise injection for the {method!r} quantizer (the paper's "
            f"Table-3 ablation) is not ported yet; use method='kquantile'")
    raise ValueError(f"unknown quantizer: {method!r}")

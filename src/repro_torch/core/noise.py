"""Uniform noise injection — the UNIQ training-time transform (paper Sec. 3.2).

At training, instead of the non-differentiable quantizer, a weight ``w`` is
passed through

    w_hat = F^{-1}( clip( F(w) + e ) ),    e ~ U[-1/(2k), +1/(2k)]

which by the uniformization trick emulates the k-quantile quantizer's error
with bin-independent uniform noise.  The transform is smooth, so gradients
flow through it (the statistics are detached constants of the step).

Also here: noise injection for the uniform and k-means quantizers (the
paper's Table-3 ablation).  Their thresholds are translated to u-space,
where bins have unequal widths, so the noise is uniform per bin with a
bin-dependent amplitude: a bin search per weight (``searchsorted``).  These
take the U[0, 1) draw ``e01`` from the caller, where the reference takes a
key and draws inside, so a test can hand both the same bits.

The k-quantile training path goes through the fused kernel
(``core/uniq.py:transform_param``); ``inject_kquantile`` is the unfused
formulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizers as Q
from repro_torch.core.distributions import GaussianModel, fit_model


def uniform_noise(gen: torch.Generator, shape, k: int,
                  dtype=torch.float32) -> torch.Tensor:
    """e ~ U[-1/(2k), +1/(2k)] — the quantization-error surrogate, drawn on
    the generator's device."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=dtype)
    return u * (1.0 / k) - 0.5 / k


def inject_kquantile(w: torch.Tensor, gen: torch.Generator, k: int,
                     model=None, channel_axis: Optional[int] = None,
                     dist: str = "gaussian") -> torch.Tensor:
    """UNIQ forward transform for the k-quantile quantizer: one CDF, one
    uniform draw, one quantile.  Noise amplitude 1/(2k) for every bin.
    ``dist`` "empirical" takes the CDF of w's sorted (sub)sample, whose
    ``searchsorted`` passes no gradient to ``w``."""
    if model is None:
        model = fit_model(w, dist, channel_axis=channel_axis)
    u = model.cdf(w)
    e = uniform_noise(gen, w.shape, k, dtype=u.dtype)
    u_hat = torch.clamp(u + e, 0.5 / k * 1e-3, 1.0 - 0.5 / k * 1e-3)
    return model.quantile(u_hat).to(w.dtype)


def inject_levels(w: torch.Tensor, e01: torch.Tensor,
                  thresholds_u: torch.Tensor, model) -> torch.Tensor:
    """Noise injection for an arbitrary quantizer given u-space thresholds.

    ``thresholds_u``: (k-1,) sorted interior thresholds in (0, 1).  Each
    weight's bin is found by ``searchsorted``; its noise is uniform with the
    width of *that* bin (paper Sec. 4.3: "the level of noise was different
    in each bin"), from ``e01`` (w's shape, U[0, 1))."""
    u = model.cdf(w)
    kb = thresholds_u.shape[0] + 1
    one = torch.ones((1,), dtype=thresholds_u.dtype,
                     device=thresholds_u.device)
    edges = torch.cat([one * 0.0, thresholds_u, one])
    idx = torch.clamp(torch.searchsorted(thresholds_u, u.contiguous()), 0,
                      kb - 1)
    width = edges[idx + 1] - edges[idx]
    e = (e01 - 0.5) * width
    u_hat = torch.clamp(u + e, 1e-6, 1.0 - 1e-6)
    return model.quantile(u_hat).to(w.dtype)


def inject_uniform_quantizer(w: torch.Tensor, e01: torch.Tensor, k: int,
                             model: Optional[GaussianModel] = None
                             ) -> torch.Tensor:
    """Noise injection emulating the [-3s, 3s] uniform quantizer."""
    if model is None:
        model = GaussianModel.fit(w)
    thr, _ = Q.uniform_thresholds(model, k)
    thr_u = model.cdf(thr.reshape(-1)).reshape(-1)
    return inject_levels(w, e01, thr_u, model)


def inject_kmeans_quantizer(w: torch.Tensor, e01: torch.Tensor, k: int,
                            model: Optional[GaussianModel] = None,
                            lloyd_iters: int = 25) -> torch.Tensor:
    """Noise injection emulating the Lloyd-Max quantizer: thresholds are
    midpoints between Lloyd levels, mapped to u-space.  Lloyd runs anew on
    every call, as in the reference (the ~280% overhead the paper
    reports)."""
    if model is None:
        model = GaussianModel.fit(w)
    levels = Q.lloyd_max(w, k, iters=lloyd_iters)
    thr = 0.5 * (levels[1:] + levels[:-1])
    thr_u = model.cdf(thr).reshape(-1)
    return inject_levels(w, e01, thr_u, model)


ABLATION_INJECT = {"uniform": inject_uniform_quantizer,
                   "kmeans": inject_kmeans_quantizer}


def inject(w: torch.Tensor, gen: torch.Generator, k: int,
           method: str = "kquantile", channel_axis: Optional[int] = None,
           dist: str = "gaussian") -> torch.Tensor:
    """Dispatch over quantizer family (training-time noise injection);
    the ablation quantizers draw their e01 from ``gen``."""
    if method == "kquantile":
        return inject_kquantile(w, gen, k, channel_axis=channel_axis,
                                dist=dist)
    if method in ABLATION_INJECT:
        e01 = torch.rand(tuple(w.shape), generator=gen, device=gen.device,
                         dtype=torch.float32)
        return ABLATION_INJECT[method](w, e01, k)
    raise ValueError(f"unknown quantizer: {method!r}")

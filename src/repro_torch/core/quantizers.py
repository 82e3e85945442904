"""Quantizers (paper Sec. 3.1).

A quantizer is a pair (thresholds T, levels Q); ``quantize`` maps a value to
a bin index (code), ``dequantize`` maps a code back to its level.

  * ``kquantile_*`` — the paper's k-quantile (balanced) quantizer.  Via the
    uniformization trick it is a uniform quantizer in u-space: codes are
    ``floor(k * F(w))`` and levels are ``F^{-1}((i+1/2)/k)``.
  * ``uniform_*``   — uniform quantizer over [-3 sigma, 3 sigma] (the
    paper's Table-3 ablation baseline).
  * ``kmeans_*``    — Lloyd-Max l2-optimal quantizer (the other Table-3
    baseline), a fixed number of Lloyd iterations.

Plain torch ops on whatever device the weights are on; no kernel: the
reference computes them in jnp, with no Pallas either.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.distributions import GaussianModel


# --------------------------------------------------------------------------
# k-quantile quantizer (the paper's contribution)
# --------------------------------------------------------------------------

def kquantile_quantize(w: torch.Tensor, model, k: int,
                       code_dtype=torch.int32) -> torch.Tensor:
    """Codes of the k-quantile quantizer:  c = floor(k * F(w)) in [0, k-1]."""
    u = model.cdf(w)
    c = torch.floor(u * k).to(torch.int32)
    c = torch.clamp(c, 0, k - 1)
    return c.to(code_dtype)


def kquantile_dequantize(codes: torch.Tensor, model, k: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Levels of the k-quantile quantizer:  q_c = F^{-1}((c + 1/2)/k)."""
    centers = (codes.to(torch.float32) + 0.5) / k
    return model.quantile(centers).to(dtype)


def kquantile_fakequant(w: torch.Tensor, model, k: int) -> torch.Tensor:
    """Round-trip quantize -> dequantize (inference-time weight values)."""
    return kquantile_dequantize(kquantile_quantize(w, model, k), model, k,
                                dtype=w.dtype)


# --------------------------------------------------------------------------
# Uniform quantizer over [-3 sigma, +3 sigma]  (ablation baseline)
# --------------------------------------------------------------------------

def _uniform_grid(model: GaussianModel, k: int):
    lo = model.mu - 3.0 * model.sigma
    hi = model.mu + 3.0 * model.sigma
    return lo, (hi - lo) / k


def uniform_thresholds(model: GaussianModel,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(thresholds (k-1, ...), levels (k, ...)) of the uniform quantizer;
    the trailing axes are the statistics' shape."""
    lo, step = _uniform_grid(model, k)
    tail = (1,) * model.mu.ndim
    i = torch.arange(1, k, dtype=torch.float32, device=lo.device)
    thr = lo + step * i.reshape((k - 1,) + tail)
    j = torch.arange(k, dtype=torch.float32, device=lo.device)
    lev = lo + step * (j.reshape((k,) + tail) + 0.5)
    return thr, lev


def uniform_quantize(w: torch.Tensor, model: GaussianModel, k: int,
                     code_dtype=torch.int8) -> torch.Tensor:
    lo, step = _uniform_grid(model, k)
    c = torch.floor((w - lo) / step).to(torch.int32)
    return torch.clamp(c, 0, k - 1).to(code_dtype)


def uniform_dequantize(codes: torch.Tensor, model: GaussianModel, k: int,
                       dtype=torch.float32) -> torch.Tensor:
    lo, step = _uniform_grid(model, k)
    return (lo + step * (codes.to(torch.float32) + 0.5)).to(dtype)


def uniform_fakequant(w: torch.Tensor, model: GaussianModel,
                      k: int) -> torch.Tensor:
    return uniform_dequantize(uniform_quantize(w, model, k), model, k,
                              dtype=w.dtype)


# --------------------------------------------------------------------------
# k-means (Lloyd-Max) quantizer  (ablation baseline)
# --------------------------------------------------------------------------

def lloyd_max(w: torch.Tensor, k: int, iters: int = 25) -> torch.Tensor:
    """Fixed-iteration Lloyd-Max on the flattened tensor; returns levels (k,).

    Initialised from the k-quantile levels.  Each iteration assigns samples
    to the nearest level (the first on a tie, as ``jnp.argmin``) and
    recomputes centroids as a one-hot product, as the reference does; empty
    bins keep their previous level.  The levels carry no gradient."""
    flat = w.detach().reshape(-1).to(torch.float32)
    model = GaussianModel.fit(flat)
    centers = (torch.arange(k, dtype=torch.float32, device=flat.device)
               + 0.5) / k
    levels = model.quantile(centers).reshape(-1)
    for _ in range(iters):
        assign = torch.argmin(torch.abs(flat[:, None] - levels[None, :]),
                              dim=1)
        one_hot = F.one_hot(assign, k).to(torch.float32)          # (n, k)
        counts = one_hot.sum(dim=0)
        sums = one_hot.T @ flat
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          levels)
        levels = torch.sort(new).values
    return levels


def levels_quantize(w: torch.Tensor, levels: torch.Tensor,
                    code_dtype=torch.int8) -> torch.Tensor:
    """Nearest-level codes for an explicit sorted codebook ``levels`` (k,)."""
    thr = 0.5 * (levels[1:] + levels[:-1])                        # (k-1,)
    c = torch.searchsorted(thr, w.to(torch.float32).contiguous())
    return c.to(code_dtype)


def levels_dequantize(codes: torch.Tensor, levels: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return levels[codes.to(torch.int64)].to(dtype)


def kmeans_fakequant(w: torch.Tensor, k: int,
                     iters: int = 25) -> torch.Tensor:
    levels = lloyd_max(w, k, iters)
    return levels_dequantize(levels_quantize(w, levels), levels,
                             dtype=w.dtype)


# --------------------------------------------------------------------------
# Generic dispatch
# --------------------------------------------------------------------------

def fakequant(w: torch.Tensor, k: int, method: str = "kquantile",
              model=None) -> torch.Tensor:
    """Deterministic quantize -> dequantize with the chosen quantizer
    (per-tensor Gaussian statistics unless ``model`` is given)."""
    if model is None:
        model = GaussianModel.fit(w)
    if method == "kquantile":
        return kquantile_fakequant(w, model, k)
    if method == "uniform":
        return uniform_fakequant(w, model, k)
    if method == "kmeans":
        return kmeans_fakequant(w, k)
    raise ValueError(f"unknown quantizer: {method!r}")

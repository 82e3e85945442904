"""The paper's k-quantile (balanced) quantizer (Sec. 3.1).

Via the uniformization trick this is a uniform quantizer in u-space: codes
are ``floor(k * F(w))`` and levels are ``F^{-1}((i+1/2)/k)``.
"""

from __future__ import annotations

import torch


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

"""Serving configuration: how trained weights are prepared for the engine.

Weights live as packed int4/int8 k-quantile codes (+ per-channel Gaussian
stats, or a per-tensor empirical codebook) and are dequantized on the fly
inside the matmul — a quarter of the weight bytes at W4, the dominant
memory term of batched decode.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import model
from repro_torch.models.lm import ModelOpts


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    w_bits: int = 16               # 4 / 8 -> k-quantile coded weights
    a_bits: int = 32
    max_len: int = 2048
    temperature: float = 0.0       # 0 = greedy
    w_dist: str = "gaussian"       # analytic levels | "empirical" codebook


def prepare_params(params, sc: ServeConfig, device="cuda"):
    """Quantize trained weights for serving (no-op at w_bits >= 16)."""
    if sc.w_bits >= 16:
        return params
    return model.quantize_for_serving(params, sc.w_bits, dist=sc.w_dist,
                                      device=device)


def make_serve_opts(opts: ModelOpts, sc: ServeConfig) -> ModelOpts:
    return dataclasses.replace(opts, a_bits=sc.a_bits)

"""Shared building blocks: norms, RoPE, the gated MLP, logit soft-capping,
initializers.

Conventions:
  * activations are (B, S, D), compute dtype bf16 (configurable);
  * parameters are stored fp32 (or k-quantile coded) and cast at use;
  * stacked per-layer parameters carry a leading (L,) axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` uses (1 + scale) (gemma convention)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    s = (1.0 + scale) if zero_centered else scale
    return (x * s.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, correction=0, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """cos / sin tables (B, S, 1, D/2) f32 for ``positions`` (B, S): what
    ``apply_rope`` rotates by.  A model call computes them once and hands
    them to every layer."""
    freqs = rope_freqs(head_dim, theta, positions.device)      # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (B, S, D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, cos_sin=None) -> torch.Tensor:
    """x: (B, S, H, D) with even D; positions: (B, S) int.

    Split-halves convention: element i pairs with element i + D/2.
    ``cos_sin`` takes precomputed ``rope_cos_sin`` tables."""
    cos, sin = cos_sin if cos_sin is not None \
        else rope_cos_sin(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
           down_w: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: down( act(x @ gate) * (x @ up) ), the weights cast to
    x's dtype; ``act`` silu or gelu (tanh approximation)."""
    dtype = x.dtype
    g = x @ gate_w.to(dtype)
    u = x @ up_w.to(dtype)
    if act == "silu":
        g = F.silu(g)
    elif act == "gelu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(act)
    return (g * u) @ down_w.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None or cap <= 0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def _truncated_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn on ``device``."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return out


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """LeCun-normal in the matmul reduction dimension."""
    fan_in = shape[in_axis]
    std = (1.0 / fan_in) ** 0.5
    # scaled in place: a full-width expert slice is 22.5 GB of f32
    return _truncated_normal(gen, shape, device).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    return (_truncated_normal(gen, shape, device) * 0.02).to(dtype)

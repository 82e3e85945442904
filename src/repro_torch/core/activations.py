"""Activation quantization (paper Sec. 3.4).

Symmetric affine int-b quantization with an absmax scale (activations after
norm layers, and post-GLU activations, are roughly symmetric); a
straight-through estimator keeps training differentiable.

``fake_quant_act`` is the training / serving emulation; ``quant_act`` /
``dequant_act`` are the real integer codecs of the serving path (the
per-token int8 codes ``lm.mm_a`` hands the ``qmatmul_a8`` kernel).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Optional

import torch


def act_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """absmax scale s.t. codes span [-(2^{b-1}-1), +(2^{b-1}-1)]: the f32
    absmax over ``axis`` (all axes when None; kept as a size-1 axis
    otherwise), clamped at 1e-8, divided by 2^{b-1} - 1."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    amax = torch.clamp(amax.to(torch.float32), min=1e-8)
    return (amax / qmax).detach()


def fake_quant_act(x: torch.Tensor, bits: int,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round-trip int-b emulation with straight-through gradient."""
    if bits >= 32:
        return x
    if scale is None:
        scale = act_scale(x, bits)
    qmax = 2.0 ** (bits - 1) - 1.0
    xf = x.to(torch.float32)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax) * scale
    # straight-through: forward quantized, backward identity
    return x + (q.to(x.dtype) - x).detach()


def quant_act(x: torch.Tensor, bits: int,
              scale: Optional[torch.Tensor] = None):
    """Real int8 codes + scale (serving path).  bits must be <= 8."""
    if bits > 8:
        raise ValueError(f"quant_act codes into int8: bits must be <= 8, "
                         f"got {bits}")
    if scale is None:
        scale = act_scale(x, bits)
    qmax = 2.0 ** (bits - 1) - 1.0
    codes = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax,
                        qmax)
    return codes.to(torch.int8), scale


def dequant_act(codes: torch.Tensor, scale: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.to(torch.float32) * scale).to(dtype)

"""Serving half of the UNIQ orchestration: offline k-quantile quantization
of weight tensors into packed codes + Gaussian statistics."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.core import quantizers as Q
from repro_torch.core.distributions import GaussianModel


def _stats_axes(w: torch.Tensor, per_channel: bool, stacked: bool):
    """Axes whose statistics are kept separate.

    stacked (L, ...) parameters always get at least per-layer statistics
    (axis 0 preserved); per_channel additionally preserves the trailing
    (output) axis.  Non-stacked: per_channel preserves the trailing axis.
    """
    if stacked:
        if per_channel and w.ndim >= 3:
            return (0, w.ndim - 1)
        return (0,)
    if per_channel and w.ndim >= 2:
        return (w.ndim - 1,)
    return None


def fit_gaussian(w: torch.Tensor, axes_keep) -> GaussianModel:
    """GaussianModel with statistics reduced over all axes not in axes_keep."""
    if axes_keep is None:
        return GaussianModel.fit(w)
    reduce_axes = tuple(a for a in range(w.ndim) if a not in axes_keep)
    mu = torch.mean(w, dim=reduce_axes, keepdim=True)
    sigma = torch.clamp(
        torch.std(w, dim=reduce_axes, correction=0, keepdim=True), min=1e-8)
    return GaussianModel(mu=mu.detach(), sigma=sigma.detach())


def default_quant_filter(path: str, leaf: torch.Tensor) -> bool:
    """Which parameters get quantized: matmul-weight-like tensors."""
    lower = path.lower()
    if leaf.ndim < 2:
        return False
    if lower.split("/")[-1] == "d":
        return False
    for token in ("norm", "router", "a_log", "dt_", "conv", "scale", "bias"):
        if token in lower:
            return False
    return True


def path_str(keys) -> str:
    """'/'-joined path of a leaf in a nested-dict parameter tree."""
    return "/".join(str(k) for k in keys)


@dataclasses.dataclass
class QuantizedTensor:
    """Packed k-quantile codes + Gaussian statistics.

    codes: uint8 (int4 packed 2/byte along last axis) or int8 (8-bit).
    mu, sigma: broadcastable statistics (per-tensor or per-channel).
    """

    codes: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    bits: int
    shape: tuple

    @property
    def k(self) -> int:
        return 2 ** self.bits

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        codes = self.codes
        if self.bits == 4:
            codes = packing.unpack_int4(codes)
        c = codes.to(torch.float32) + (128.0 if self.k == 256 else 0.0)
        centers = torch.clamp((c + 0.5) / self.k, 1e-6, 1 - 1e-6)
        w = self.mu + self.sigma * torch.special.ndtri(centers)
        return w.reshape(self.shape).to(dtype)


def quantize_tensor(w: torch.Tensor, bits: int, per_channel: bool = True,
                    stacked: bool = False) -> QuantizedTensor:
    """Offline k-quantile quantization of a weight tensor for serving."""
    model = fit_gaussian(w, _stats_axes(w, per_channel, stacked))
    codes = Q.kquantile_quantize(w, model, 2 ** bits, code_dtype=torch.int32)
    if bits == 4:
        stored = packing.pack_int4(codes)
    elif bits == 8:
        stored = (codes - 128).to(torch.int8)  # storage offset for k=256
    else:
        raise ValueError(f"serving bits must be 4 or 8, got {bits}")
    return QuantizedTensor(stored, model.mu.to(torch.float32),
                           model.sigma.to(torch.float32), bits,
                           tuple(w.shape))

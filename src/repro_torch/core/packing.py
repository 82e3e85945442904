"""Bit-packing of quantization codes for storage/serving.

int4 codes (k <= 16) are packed two-per-byte along the last axis: low nibble
holds the even element, high nibble the odd element.  The last axis must be
even.  int8 codes (k <= 256) are stored as-is.
"""

from __future__ import annotations

import torch


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(..., 2n) int codes in [0,16) -> (..., n) uint8 packed.

    Codes are masked to their low nibble: without the mask, bit 4 of an
    out-of-range even element would bleed into its odd neighbor's nibble.
    """
    if codes.shape[-1] % 2 != 0:
        raise ValueError(f"last dim must be even, got {tuple(codes.shape)}")
    c = codes.to(torch.uint8) & 0x0F
    lo = c[..., 0::2]
    hi = c[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 packed -> (..., 2n) int8 codes in [0,16)."""
    lo = (packed & 0x0F).to(torch.int8)
    hi = ((packed >> 4) & 0x0F).to(torch.int8)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def packed_shape(shape, bits: int):
    """Storage shape for codes of ``shape`` at ``bits`` in {4, 8}."""
    if bits == 4:
        return (*shape[:-1], shape[-1] // 2)
    if bits == 8:
        return tuple(shape)
    raise ValueError(f"unsupported storage bits: {bits}")


def storage_dtype(bits: int):
    if bits in (4, 8):
        return torch.uint8 if bits == 4 else torch.int8
    raise ValueError(f"unsupported storage bits: {bits}")

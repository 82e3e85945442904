"""Plain PyTorch codec shared by every module of the port.

k-quantile codes, the k-entry level table and the analytic dequant: what the
CPU tests hold against the JAX reference, and what the kernels' plain
versions (each beside its kernel, in ``qmatmul.py`` and ``paged_attn.py``)
are built from.
"""

from __future__ import annotations

import functools

import torch

_SQRT2 = 1.4142135623730951
_EPS = 1e-6


def phi(z: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erf (the KV-row / kernel formulation)."""
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def phi_inv(u: torch.Tensor) -> torch.Tensor:
    """Standard normal quantile via erfinv."""
    return _SQRT2 * torch.erfinv(2.0 * u - 1.0)


def code_offset(k: int) -> int:
    """int8-stored codes are offset by -128 iff k == 256 (range fit)."""
    return 128 if k == 256 else 0


def kquantile_codes_ref(w: torch.Tensor, mu: torch.Tensor,
                        sigma: torch.Tensor, k: int) -> torch.Tensor:
    """weights -> int8 codes in [0, k) - code_offset(k)."""
    z = (w.to(torch.float32) - mu) / sigma
    u = torch.clamp(phi(z), _EPS, 1.0 - _EPS)
    c = torch.clamp(torch.floor(u * k), 0, k - 1) - code_offset(k)
    return c.to(torch.int8)


@functools.lru_cache(maxsize=None)
def _level_table_cpu(k: int) -> torch.Tensor:
    centers = torch.clamp(
        (torch.arange(k, dtype=torch.float32) + 0.5) / k, _EPS, 1 - _EPS)
    return phi_inv(centers)


_TABLES = {}


def level_table(k: int, device=None) -> torch.Tensor:
    """The k standardized levels  Phi^{-1}((c + 1/2) / k), c in [0, k).

    Always computed on the CPU and copied, so every device sees the same
    f32 values; cached per (k, device).  Treat the result as read-only.
    """
    key = (k, device)
    t = _TABLES.get(key)
    if t is None:
        t = _level_table_cpu(k)
        if device is not None and torch.device(device).type != "cpu":
            t = t.to(device)
        _TABLES[key] = t
    return t


def kquantile_dequant_ref(codes: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, k: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """int codes -> analytic k-quantile levels  mu + sigma * table[c].

    Applies the int8 storage offset for k == 256 (see code_offset)."""
    idx = codes.to(torch.int64) + code_offset(k)
    return (mu + sigma * level_table(k, codes.device)[idx]).to(dtype)

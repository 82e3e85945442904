"""Public entry points of the kernels: shape handling around ``qmatmul``
and the launch counters (the build of the CUDA sources is ``loader.py``).

``qmatmul`` here takes activations of any leading shape and per-tensor or
per-channel statistics and hands the kernel wrapper what it takes: a 2-D
contiguous ``a`` and (1, N) statistics.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import paged_attn as _pa
from repro_torch.kernels import qmatmul as _qmm


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"qmatmul": _qmm.qmatmul.launches,
            "paged_quant_attention": _pa.paged_quant_attention.launches}


def reset_launch_counts() -> None:
    _qmm.qmatmul.launches = 0
    _pa.paged_quant_attention.launches = 0


def _stats(s: torch.Tensor, N: int) -> torch.Tensor:
    """(1, N) contiguous f32 view of per-channel or per-tensor statistics
    (the stored layout already is one: nothing is copied on the hot path)."""
    if s.shape[-1] != N:
        s = s.expand(1, N)
    if s.dtype != torch.float32:
        s = s.to(torch.float32)
    return s if s.is_contiguous() else s.contiguous()


def qmatmul(a: torch.Tensor, w_packed: torch.Tensor, mu: torch.Tensor,
            sigma: torch.Tensor, *, bits: int, out_dtype=torch.float32,
            use_kernel: bool = True, **tuning) -> torch.Tensor:
    """a (..., K) @ dequant(w) (K, N) -> (..., N).

    ``mu``/``sigma`` are (1, N) per-channel or (1, 1) per-tensor f32.
    ``use_kernel=False`` is the comparison hook: it computes the plain
    PyTorch version on whatever device the tensors are on.
    """
    K = a.shape[-1]
    N = w_packed.shape[1] * 2 if bits == 4 else w_packed.shape[1]
    a2 = a.reshape(-1, K)
    mu, sigma = _stats(mu, N), _stats(sigma, N)
    if use_kernel:
        if not a2.is_contiguous():
            a2 = a2.contiguous()
        out = _qmm.qmatmul(a2, w_packed, mu, sigma, bits=bits,
                           out_dtype=out_dtype, **tuning)
    else:
        out = _qmm.qmatmul_plain(a2, w_packed, mu, sigma, bits=bits,
                                 out_dtype=out_dtype)
    return out.reshape(*a.shape[:-1], N)

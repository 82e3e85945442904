"""Public entry points of the kernels: shape handling around ``qmatmul``
and ``uniq_noise``, the UNIQ transform's autograd function, and the launch
counters (the build of the CUDA sources is ``loader.py``).

``qmatmul`` here takes activations of any leading shape and per-tensor or
per-channel statistics and hands the kernel wrapper what it takes: a 2-D
contiguous ``a`` and (1, N) statistics.  ``uniq_transform`` differentiates
through the ``uniq_noise`` forward kernel with the backward kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import paged_attn as _pa
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels import uniq_noise as _un

_COUNTED = {"qmatmul": _qmm.qmatmul,
            "paged_quant_attention": _pa.paged_quant_attention,
            "uniq_noise_fwd": _un.uniq_noise_fwd,
            "uniq_noise_bwd": _un.uniq_noise_bwd}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


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


# --------------------------------------------------------------------------
# uniq_transform: the fused UNIQ transform with its hand-written backward
# --------------------------------------------------------------------------

def _grouped(w: torch.Tensor):
    """View of a weight tensor in the (G, R, C) kernel layout, and the
    function that takes a (G, R, C) result back to w's shape."""
    if w.ndim == 2:
        return w[None], (lambda x: x[0])
    if w.ndim == 3:
        return w, (lambda x: x)
    flat = w.reshape(w.shape[0], -1, w.shape[-1])
    return flat, (lambda x: x.reshape(w.shape))


def grouped_stats(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Keep-dims statistics of ``w`` (per layer and / or per trailing
    channel, or one for the whole tensor) in the (G, 1, C) / (G, 1, 1)
    layout of ``_grouped(w)``, f32 contiguous."""
    G = 1 if w.ndim == 2 else w.shape[0]
    s = s.to(torch.float32)
    s = s.reshape(-1, 1, s.shape[-1] if s.ndim else 1)
    if s.shape[0] != G:                    # one statistic for every group
        s = s.expand(G, 1, s.shape[-1])
    return s.contiguous()


class _UniqTransform(torch.autograd.Function):
    """w -> w_hat through ``uniq_noise_fwd``; the gradient through
    ``uniq_noise_bwd``.  Only ``w`` receives a gradient: the statistics are
    constants of the step (detached, as in ``fit_gaussian``)."""

    @staticmethod
    def forward(ctx, w, mu, sigma, mode, e01, k, use_kernel):
        fwd = _un.uniq_noise_fwd if use_kernel else _un.uniq_noise_fwd_plain
        w_hat = fwd(w, mu, sigma, mode, e01, k=k)
        ctx.save_for_backward(w, w_hat, mu, sigma, mode)
        ctx.use_kernel = use_kernel
        return w_hat

    @staticmethod
    def backward(ctx, g):
        w, w_hat, mu, sigma, mode = ctx.saved_tensors
        bwd = _un.uniq_noise_bwd if ctx.use_kernel \
            else _un.uniq_noise_bwd_plain
        dw = bwd(g.contiguous(), w, w_hat, mu, sigma, mode)
        return dw, None, None, None, None, None, None


def uniq_transform(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                   mode, e01: torch.Tensor, *, k: int,
                   use_kernel: bool = True) -> torch.Tensor:
    """Fused UNIQ transform on (G, R, C) grouped weights (see
    ``uniq_noise.py``), differentiable in ``w``.

    ``mode`` is (G,) or one value for every group, on any device (copied to
    w's).  ``e01`` is the (G, R, C) f32 U[0, 1) draw: the caller makes it,
    so a test can hand both frameworks the same noise.  ``use_kernel=False``
    is the comparison hook: it computes the plain versions on whatever
    device the tensors are on.
    """
    mode = torch.as_tensor(mode).to(device=w.device,
                                    dtype=torch.int32).reshape(-1)
    if mode.numel() == 1 and w.shape[0] != 1:
        mode = mode.expand(w.shape[0])
    return _UniqTransform.apply(w, mu.detach(), sigma.detach(),
                                mode.contiguous(), e01, k, use_kernel)

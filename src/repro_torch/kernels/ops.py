"""Public entry points of the kernels: shape handling around the matmuls,
the k-quantile codec and ``uniq_noise``, the UNIQ transform's autograd
function, and the launch counters (the build of the CUDA sources is
``loader.py``).

``qmatmul`` / ``qmatmul_lut`` / ``qmatmul_a8`` here take activations of any
leading shape and per-tensor or per-channel statistics and hand the kernel
wrappers what they take: a 2-D contiguous ``a`` and (1, N) statistics;
``qmatmul_experts`` / ``qmatmul_lut_experts`` take an (E, C, K) expert
buffer and a layer's stacked statistics ((1, 1, N) or (1, 1, 1)).
``quantize_weights`` / ``dequantize_weights`` take values of any shape with
statistics that broadcast against them and hand the codec kernels the
(G, R, C) layout.  ``uniq_transform`` differentiates through the
``uniq_noise`` forward kernel with the backward kernel;
``uniq_transform_onchip`` does the same with the forward that draws its
noise inside the kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core import packing
from repro_torch.kernels import kquantile as _kq
from repro_torch.kernels import paged_attn as _pa
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels import uniq_noise as _un

_COUNTED = {"qmatmul": _qmm.qmatmul,
            "paged_quant_attention": _pa.paged_quant_attention,
            "uniq_noise_fwd": _un.uniq_noise_fwd,
            "uniq_noise_fwd_onchip": _un.uniq_noise_fwd_onchip,
            "uniq_noise_bwd": _un.uniq_noise_bwd,
            "qmatmul_a8": _qmm.qmatmul_a8,
            "qmatmul_lut": _qmm.qmatmul_lut,
            "qmatmul_experts": _qmm.qmatmul_experts,
            "qmatmul_lut_experts": _qmm.qmatmul_lut_experts,
            "kquantile_quantize": _kq.kquantile_quantize,
            "kquantile_dequantize": _kq.kquantile_dequantize,
            "kquantile_dequantize_paged": _kq.kquantile_dequantize_paged,
            "kv_append": _kq.kv_append}


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


def qmatmul_lut(a: torch.Tensor, w_packed: torch.Tensor, lut: torch.Tensor,
                *, bits: int, out_dtype=torch.float32,
                use_kernel: bool = True, **tuning) -> torch.Tensor:
    """a (..., K) @ lut-dequant(w) (K, N) -> (..., N).

    ``lut`` is (k, N) per-column or (k,) one codebook for every column (the
    engine's per-tensor ``q_lut``), f32.  ``use_kernel=False`` is the
    comparison hook: it computes the plain PyTorch version on whatever
    device the tensors are on.
    """
    K = a.shape[-1]
    N = w_packed.shape[1] * 2 if bits == 4 else w_packed.shape[1]
    a2 = a.reshape(-1, K)
    if use_kernel:
        out = _qmm.qmatmul_lut(a2.contiguous(), w_packed, lut.contiguous(),
                               bits=bits, out_dtype=out_dtype, **tuning)
    else:
        out = _qmm.qmatmul_lut_plain(a2, w_packed, lut, bits=bits,
                                     out_dtype=out_dtype)
    return out.reshape(*a.shape[:-1], N)


def qmatmul_a8(a_codes: torch.Tensor, a_scale: torch.Tensor,
               w_packed: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
               *, bits: int, out_dtype=torch.float32,
               use_kernel: bool = True, **tuning) -> torch.Tensor:
    """(a_codes * a_scale) (..., K) @ dequant(w) (K, N) -> (..., N).

    ``a_codes`` int8; ``a_scale`` one f32 value or (..., 1) per row (the
    per-token scales of ``core.activations.act_scale(x, bits, axis=-1)``).
    ``use_kernel=False`` is the comparison hook (see ``qmatmul``).
    """
    K = a_codes.shape[-1]
    N = w_packed.shape[1] * 2 if bits == 4 else w_packed.shape[1]
    c2 = a_codes.reshape(-1, K)
    scale = a_scale.to(torch.float32)
    scale = scale.reshape(1) if scale.numel() == 1 \
        else scale.reshape(c2.shape[0], 1)
    mu, sigma = _stats(mu, N), _stats(sigma, N)
    if use_kernel:
        out = _qmm.qmatmul_a8(c2.contiguous(), scale.contiguous(), w_packed,
                              mu, sigma, bits=bits, out_dtype=out_dtype,
                              **tuning)
    else:
        out = _qmm.qmatmul_a8_plain(c2, scale, w_packed, mu, sigma,
                                    bits=bits, out_dtype=out_dtype)
    return out.reshape(*a_codes.shape[:-1], N)


def qmatmul_experts(a: torch.Tensor, w_packed: torch.Tensor,
                    mu: torch.Tensor, sigma: torch.Tensor,
                    rows: torch.Tensor, *, bits: int, out_dtype=torch.float32,
                    use_kernel: bool = True, **tuning) -> torch.Tensor:
    """a (E, C, K) @ dequant(w[e]) (K, N) for each expert e -> (E, C, N),
    rows of expert e at or past ``rows[e]`` (E,) taken as zeros.

    ``mu``/``sigma`` are the layer's statistics shared by its experts, of
    any shape with N or 1 trailing elements.  ``use_kernel=False`` is the
    comparison hook: the plain version on whatever device the tensors are
    on.
    """
    N = w_packed.shape[-1] * 2 if bits == 4 else w_packed.shape[-1]
    mu = _stats(mu.reshape(1, -1), N)
    sigma = _stats(sigma.reshape(1, -1), N)
    rows = rows.to(torch.int32)
    if use_kernel:
        return _qmm.qmatmul_experts(a.contiguous(), w_packed, mu, sigma,
                                    rows.contiguous(), bits=bits,
                                    out_dtype=out_dtype, **tuning)
    return _qmm.qmatmul_experts_plain(a, w_packed, mu, sigma, rows,
                                      bits=bits, out_dtype=out_dtype)


def qmatmul_lut_experts(a: torch.Tensor, w_packed: torch.Tensor,
                        lut: torch.Tensor, rows: torch.Tensor, *, bits: int,
                        out_dtype=torch.float32, use_kernel: bool = True,
                        **tuning) -> torch.Tensor:
    """``qmatmul_experts`` with a codebook ``lut`` (k,) or (k, N) f32 shared
    by the experts.  ``use_kernel=False`` is the comparison hook."""
    rows = rows.to(torch.int32)
    if use_kernel:
        return _qmm.qmatmul_lut_experts(a.contiguous(), w_packed,
                                        lut.contiguous(), rows.contiguous(),
                                        bits=bits, out_dtype=out_dtype,
                                        **tuning)
    return _qmm.qmatmul_lut_experts_plain(a, w_packed, lut, rows, bits=bits,
                                          out_dtype=out_dtype)


# --------------------------------------------------------------------------
# The deterministic k-quantile codec (serving: weights at load, KV rows)
# --------------------------------------------------------------------------

def codec_layout(shape, C: int, mu: torch.Tensor, sigma: torch.Tensor):
    """The (G, R, C) kernel layout of values of ``shape`` (trailing axis of
    C elements) under statistics that broadcast against them, and those
    statistics as contiguous (G, 1, C) / (G, 1, 1) f32.

    G runs over the leading axes along which the statistics vary, R over
    the axes between them and the last one, along which they are constant:
    per-channel (1, N) statistics of a (K, N) weight give (1, K, N),
    per-layer (L, 1, N) of a stacked (L, K, N) weight (L, K, N), per-row
    (..., KV, 1) of KV rows (..., KV, hd) (rows * KV, 1, hd).  Where R * C
    would reach ``kquantile.MAX_GROUP``, leading axes of R move into G (the
    statistics are expanded along them): the codes do not change.
    """
    nd = len(shape)
    lead = tuple(shape[:-1])
    s_shape = tuple(mu.shape)
    if len(s_shape) > nd or tuple(sigma.shape) != s_shape:
        raise ValueError(f"statistics {tuple(mu.shape)} / "
                         f"{tuple(sigma.shape)} do not broadcast against "
                         f"{tuple(shape)}")
    s_shape = (1,) * (nd - len(s_shape)) + s_shape
    if s_shape[-1] not in (1, C):
        raise ValueError(f"statistics {tuple(mu.shape)} do not broadcast "
                         f"against {C} columns")
    p = nd - 1
    while p > 0 and s_shape[p - 1] == 1:
        p -= 1
    # a group the kernels refuse (2^31 elements or more) is cut along its
    # leading axes, over which the statistics are constant: the layer slice
    # of an expert stack (1, E, d, f) with per-column statistics is E groups
    # of (d, f)
    while p < nd - 1 and math.prod(lead[p:]) * C >= _kq.MAX_GROUP:
        p += 1
    G = math.prod(lead[:p])
    R = math.prod(lead[p:])

    def prep(t):
        t = t.to(torch.float32).reshape(s_shape)
        t = t.expand(*lead[:p], *s_shape[p:])
        return t.reshape(G, 1, s_shape[-1]).contiguous()

    return G, R, prep(mu), prep(sigma)


def quantize_weights(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                     *, bits: int, use_kernel: bool = True) -> torch.Tensor:
    """Values -> stored codes of w's shape: (..., C // 2) uint8 packed two
    per byte at 4 bits, (..., C) int8 (k = 256 offset) at 8.

    Statistics broadcast against ``w`` (see ``codec_layout``).  4-bit
    codes are packed inside the kernel.  ``use_kernel=False`` is the
    comparison hook: the plain version on whatever device the tensors are
    on.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k = 2 ** bits
    C = w.shape[-1]
    G, R, mu3, sigma3 = codec_layout(tuple(w.shape), C, mu, sigma)
    w3 = w.reshape(G, R, C)
    packed = bits == 4
    if use_kernel:
        codes = _kq.kquantile_quantize(w3.contiguous(), mu3, sigma3, k=k,
                                       packed=packed)
    else:
        codes = _kq.kquantile_quantize_plain(w3, mu3, sigma3, k=k,
                                             packed=packed)
    return codes.reshape(packing.packed_shape(tuple(w.shape), bits))


def dequantize_weights(codes: torch.Tensor, mu: torch.Tensor,
                       sigma: torch.Tensor, *, bits: int,
                       out_dtype=torch.bfloat16,
                       use_kernel: bool = True) -> torch.Tensor:
    """Stored codes (as ``quantize_weights`` gives them) -> values
    ``mu + sigma * level_table(k)[c]`` of the unpacked shape; packed 4-bit
    codes are unpacked inside the kernel.  ``use_kernel=False`` is the
    comparison hook."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k = 2 ** bits
    C = codes.shape[-1] * (2 if bits == 4 else 1)
    shape = (*codes.shape[:-1], C)
    G, R, mu3, sigma3 = codec_layout(shape, C, mu, sigma)
    c3 = codes.reshape(G, R, codes.shape[-1])
    if use_kernel:
        out = _kq.kquantile_dequantize(c3.contiguous(), mu3, sigma3, k=k,
                                       out_dtype=out_dtype)
    else:
        out = _kq.kquantile_dequantize_plain(c3, mu3, sigma3, k=k,
                                             out_dtype=out_dtype)
    return out.reshape(shape)


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
    """w -> w_hat through a ``uniq_noise`` forward ``fwd`` (noise as an
    operand ``e01``, or drawn on chip under an int ``key``); the gradient
    through ``uniq_noise_bwd``, which needs no noise.  Only ``w`` receives a
    gradient: the statistics are constants of the step (detached, as in
    ``fit_gaussian``)."""

    @staticmethod
    def forward(ctx, w, mu, sigma, mode, noise, k, fwd, use_kernel):
        w_hat = fwd(w, mu, sigma, mode, noise, k=k)
        if isinstance(mode, torch.Tensor):
            ctx.save_for_backward(w, w_hat, mu, sigma, mode)
            ctx.mode = None
        else:                              # one mode, by value
            ctx.save_for_backward(w, w_hat, mu, sigma)
            ctx.mode = mode
        ctx.use_kernel = use_kernel
        return w_hat

    @staticmethod
    def backward(ctx, g):
        w, w_hat, mu, sigma, *mode = ctx.saved_tensors
        bwd = _un.uniq_noise_bwd if ctx.use_kernel \
            else _un.uniq_noise_bwd_plain
        dw = bwd(g.contiguous(), w, w_hat, mu, sigma,
                 mode[0] if mode else ctx.mode)
        return dw, None, None, None, None, None, None, None


def _group_modes(mode, w: torch.Tensor):
    """The kernels' mode argument: one Python int where every group has one
    mode known on the host (a Python or numpy int, or a one-element CPU
    tensor), handed to the kernels by value with nothing copied to the
    device; else a (G,) int32 tensor on w's device."""
    mode = torch.as_tensor(mode)
    if mode.device.type == "cpu" and mode.numel() == 1:
        return int(mode)
    mode = mode.to(device=w.device, dtype=torch.int32).reshape(-1)
    if mode.numel() == 1 and w.shape[0] != 1:
        mode = mode.expand(w.shape[0])
    return mode.contiguous()


def uniq_transform(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                   mode, e01: torch.Tensor, *, k: int,
                   use_kernel: bool = True) -> torch.Tensor:
    """Fused UNIQ transform on (G, R, C) grouped weights (see
    ``uniq_noise.py``), differentiable in ``w``.

    ``mode`` is (G,) or one value for every group, on any device (copied to
    w's, except one value held on the host, which goes by value).  ``e01``
    is the (G, R, C) f32 U[0, 1) draw: the caller makes it, so a test can
    hand both frameworks the same noise.  ``use_kernel=False``
    is the comparison hook: it computes the plain versions on whatever
    device the tensors are on.
    """
    fwd = _un.uniq_noise_fwd if use_kernel else _un.uniq_noise_fwd_plain
    return _UniqTransform.apply(w, mu.detach(), sigma.detach(),
                                _group_modes(mode, w), e01, k, fwd,
                                use_kernel)


def uniq_transform_onchip(w: torch.Tensor, mu: torch.Tensor,
                          sigma: torch.Tensor, mode, key: int, *, k: int,
                          use_kernel: bool = True) -> torch.Tensor:
    """``uniq_transform`` with the noise drawn inside the forward kernel
    (``uniq_noise_fwd_onchip``) from Philox4x32-10 under the leaf's 64-bit
    ``key``: no (G, R, C) noise tensor is made or read.  The plain versions
    (``use_kernel=False``, or CPU tensors) draw the same bits with
    ``ref.onchip_e01``, so the card and the CPU see the same noise."""
    fwd = _un.uniq_noise_fwd_onchip if use_kernel \
        else _un.uniq_noise_fwd_onchip_plain
    return _UniqTransform.apply(w, mu.detach(), sigma.detach(),
                                _group_modes(mode, w), int(key), k, fwd,
                                use_kernel)

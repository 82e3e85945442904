"""Deterministic k-quantile quantize / dequantize: CUDA kernels + plain
PyTorch versions.

Replaces the TPU kernels ``kquantile_quantize`` and ``kquantile_dequantize``
of ``src/repro/kernels/kquantile.py``.  The source is ``csrc/kquantile.cu``
(see its header for what bounds it and what the design does about that).
Both wrappers launch their kernel for CUDA tensors and take the plain
version only for CPU tensors.

Layout, as the reference's: values ``(G, R, C)``, statistics ``(G, 1, C)``
(per column) or ``(G, 1, 1)`` (per group) f32.  Codes are int8 (with the
k = 256 storage offset of ``ref.code_offset``); ``kquantile_dequantize``
also takes 4-bit codes packed two per byte, ``(G, R, C // 2)`` uint8, and
unpacks them inside the kernel.  Any R and C: there is no divisibility
condition.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref

_DTYPES = (torch.float32, torch.bfloat16)


def kquantile_quantize_plain(w, mu, sigma, *, k: int) -> torch.Tensor:
    """Plain version of the quantize kernel (``ref.kquantile_codes_ref``)."""
    return kref.kquantile_codes_ref(w, mu, sigma, k)


def kquantile_dequantize_plain(codes, mu, sigma, *, k: int,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the dequantize kernel: unpack packed codes, then
    ``ref.kquantile_dequant_ref``."""
    if codes.dtype == torch.uint8:
        codes = packing.unpack_int4(codes)
    return kref.kquantile_dequant_ref(codes, mu, sigma, k, dtype=out_dtype)


def _check_k(k: int) -> None:
    if k < 2 or k > 256 or k & (k - 1):
        raise ValueError(f"k must be a power of two in [2, 256], got {k}")


def _check_stats(x, mu, sigma, C):
    if x.ndim != 3:
        raise ValueError(f"expected a (G, R, C) tensor, got {tuple(x.shape)}")
    G = x.shape[0]
    for name, s in (("mu", mu), ("sigma", sigma)):
        if s.dtype != torch.float32 or tuple(s.shape) not in (
                (G, 1, C), (G, 1, 1)):
            raise ValueError(f"{name} must be ({G}, 1, {C}) or ({G}, 1, 1) "
                             f"float32, got {tuple(s.shape)} {s.dtype}")
        if s.device != x.device:
            raise ValueError("all operands must live on one device")
    if mu.shape != sigma.shape:
        raise ValueError("mu and sigma must have one shape")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"kquantile runs on cuda or cpu tensors, got "
                           f"{x.device}")


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_FNS = {}


def _bind(name: str):
    """A C entry point of ``csrc/kquantile.cu``, built and bound at first
    use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(loader.load("kquantile"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "kquantile_quantize_launch":
            fn.argtypes = [p, i, p, p, i, p, i, ll, ll, ll, p]
        else:
            fn.argtypes = [p, i, p, p, i, p, p, i, i, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def kquantile_quantize(w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                       *, k: int) -> torch.Tensor:
    """(G, R, C) f32 / bf16 values -> (G, R, C) int8 codes.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``kquantile_quantize.launches`` counts kernel launches.
    """
    _check_k(k)
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    _check_stats(w, mu, sigma, w.shape[-1] if w.ndim == 3 else 0)
    if w.device.type == "cpu":
        return kquantile_quantize_plain(w, mu, sigma, k=k)
    _require_contiguous(w=w, mu=mu, sigma=sigma)
    G, R, C = w.shape
    if w.numel() == 0:
        return torch.empty(w.shape, dtype=torch.int8, device=w.device)
    fn = _bind("kquantile_quantize_launch")
    with loader.on_device(w.device):
        out = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), int(w.dtype == torch.bfloat16), mu.data_ptr(),
                sigma.data_ptr(), int(mu.shape[-1] != 1), out.data_ptr(), k,
                G, R, C, stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_quantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k})")
    kquantile_quantize.launches += 1
    return out


def kquantile_dequantize(codes: torch.Tensor, mu: torch.Tensor,
                         sigma: torch.Tensor, *, k: int,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """(G, R, C) int8 codes, or (G, R, C // 2) uint8 packed 4-bit codes
    (k <= 16), -> (G, R, C) ``out_dtype`` levels ``mu + sigma * table[c]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``kquantile_dequantize.launches`` counts kernel launches.
    """
    _check_k(k)
    packed = codes.dtype == torch.uint8
    if codes.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"codes must be int8 or packed uint8, got "
                        f"{codes.dtype}")
    if packed and k > 16:
        raise ValueError(f"packed 4-bit codes hold k <= 16 levels, got k={k}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    C = codes.shape[-1] * (2 if packed else 1) if codes.ndim == 3 else 0
    _check_stats(codes, mu, sigma, C)
    if codes.device.type == "cpu":
        return kquantile_dequantize_plain(codes, mu, sigma, k=k,
                                          out_dtype=out_dtype)
    _require_contiguous(codes=codes, mu=mu, sigma=sigma)
    G, R = codes.shape[:2]
    if codes.numel() == 0:
        return torch.empty((G, R, C), dtype=out_dtype, device=codes.device)
    fn = _bind("kquantile_dequantize_launch")
    table = kref.level_table(k, codes.device)
    with loader.on_device(codes.device):
        out = torch.empty((G, R, C), dtype=out_dtype, device=codes.device)
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = fn(codes.data_ptr(), int(packed), mu.data_ptr(),
                sigma.data_ptr(), int(mu.shape[-1] != 1), table.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16), k, G, R, C,
                stream)
    if rc != 0:
        raise RuntimeError(f"kquantile_dequantize kernel launch failed with "
                           f"code {rc} (G={G}, R={R}, C={C}, k={k}, "
                           f"packed={packed})")
    kquantile_dequantize.launches += 1
    return out


kquantile_quantize.launches = 0
kquantile_dequantize.launches = 0

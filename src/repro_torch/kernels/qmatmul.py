"""Dequant-fused matmul over k-quantile-coded weights: CUDA kernel + plain
PyTorch version.

Replaces the TPU kernel ``qmatmul`` of ``src/repro/kernels/qmatmul.py``.
The kernel source is ``csrc/qmatmul.cu`` (see its header for what bounds it
on Hopper and what the design does about that).  ``qmatmul`` launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One point on the block-shape tuning axis: ``bm`` rows per block
    select the kernel instantiation (8, 16, 32 or 64; the tensor-core body's
    narrowest tile is 16 rows and serves 8 too).  A block's tile is always
    128 columns wide; a stage is 64 rows of K on the tensor cores and 32 on
    the CUDA cores."""
    bm: int


TUNED_BLOCKS = {
    "decode8": BlockConfig(bm=8),
    "decode16": BlockConfig(bm=16),
    "decode": BlockConfig(bm=32),
    "prefill": BlockConfig(bm=64),
}

_DECODE_M_MAX = 32
_MAX_SPLITK = 16
_TARGET_BLOCKS = 1056         # eight blocks per SM of a 132-SM card: a block
                              # walks its K range serially, so it is the
                              # number of resident blocks that hides latency


def default_blocks(M: int) -> BlockConfig:
    """Pick the block config for a call of M rows."""
    if M <= 8:
        return TUNED_BLOCKS["decode8"]
    if M <= 16:
        return TUNED_BLOCKS["decode16"]
    if M <= _DECODE_M_MAX:
        return TUNED_BLOCKS["decode"]
    return TUNED_BLOCKS["prefill"]


def default_splitk(K: int, N: int) -> int:
    """Split count over K: a power of two that brings the grid near
    ``_TARGET_BLOCKS`` blocks, each split at least 256 rows of K deep.  A
    function of (K, N) only — never of M — so a row's summation order, and
    with it its bits, do not depend on which rows share the call."""
    n_blocks = -(-N // 128)
    want = max(1, min(_MAX_SPLITK, _TARGET_BLOCKS // n_blocks, K // 256))
    return 1 << (want.bit_length() - 1)


def qmatmul_plain(a: torch.Tensor, w_packed: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor, *, bits: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: unpack, level-table gather, ``a.float() @ w``.

    The dequantized weight is rounded to ``a``'s dtype first (a no-op for
    f32 activations), as the reference's serving matmul and its TPU kernel
    do; the product itself accumulates in f32."""
    k = 2 ** bits
    codes = packing.unpack_int4(w_packed) if bits == 4 else w_packed
    w = kref.kquantile_dequant_ref(codes, mu, sigma, k, dtype=a.dtype)
    return (a.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def _check(a, w_packed, mu, sigma, bits, out_dtype):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if a.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"a and w must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(w_packed.shape)}")
    want = packing.storage_dtype(bits)
    if w_packed.dtype != want:
        raise TypeError(f"w must be {want} at bits={bits}, got "
                        f"{w_packed.dtype}")
    M, K = a.shape
    N = w_packed.shape[1] * 2 if bits == 4 else w_packed.shape[1]
    if w_packed.shape[0] != K:
        raise ValueError(f"K mismatch: a {tuple(a.shape)} vs w "
                         f"{tuple(w_packed.shape)}")
    for name, s in (("mu", mu), ("sigma", sigma)):
        if tuple(s.shape) != (1, N) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be (1, {N}) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"a must be bfloat16 or float32, got {a.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got "
                        f"{out_dtype}")
    for t in (w_packed, mu, sigma):
        if t.device != a.device:
            raise ValueError("all operands must live on one device")
    return M, K, N


_FN = None


def _bind():
    """The kernel's C entry point, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = loader.load("qmatmul").qmatmul_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def qmatmul(a: torch.Tensor, w_packed: torch.Tensor, mu: torch.Tensor,
            sigma: torch.Tensor, *, bits: int, out_dtype=torch.float32,
            blocks: Optional[BlockConfig] = None,
            splitk: Optional[int] = None) -> torch.Tensor:
    """a (M, K) @ dequant(w_packed) (K, N) -> (M, N) ``out_dtype``.

    w_packed : (K, N//2) uint8 if bits==4 else (K, N) int8.
    mu/sigma : (1, N) f32 per-out-channel statistics.
    blocks/splitk : tuning axes; None picks the defaults for the shape.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``qmatmul.launches`` counts kernel launches.
    """
    M, K, N = _check(a, w_packed, mu, sigma, bits, out_dtype)
    if a.device.type == "cpu":
        return qmatmul_plain(a, w_packed, mu, sigma, bits=bits,
                             out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise RuntimeError(f"qmatmul runs on cuda or cpu tensors, got "
                           f"{a.device}")
    if M == 0:
        return torch.empty((0, N), dtype=out_dtype, device=a.device)
    for name, t in (("a", a), ("w", w_packed), ("mu", mu), ("sigma", sigma)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cfg = blocks if blocks is not None else default_blocks(M)
    if cfg.bm not in (8, 16, 32, 64):
        raise ValueError(f"no kernel instantiation for {cfg}")
    nsplit = splitk if splitk is not None else default_splitk(K, N)
    fn = _bind()
    table = kref.level_table(2 ** bits, a.device)
    with loader.on_device(a.device):
        part = torch.empty((nsplit, M, N), dtype=torch.float32,
                           device=a.device)
        out = torch.empty((M, N), dtype=out_dtype, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), int(a.dtype == torch.bfloat16),
                w_packed.data_ptr(), bits, mu.data_ptr(), sigma.data_ptr(),
                table.data_ptr(), part.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), M, K, N, cfg.bm, nsplit,
                stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul kernel launch failed with code {rc} "
                           f"(M={M}, K={K}, N={N}, bits={bits}, {cfg}, "
                           f"splitk={nsplit})")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0

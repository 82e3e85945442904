"""Decode attention off the k-quantile-coded paged KV pool: CUDA kernel +
plain PyTorch version.

Replaces the TPU kernel ``paged_quant_attention`` of
``src/repro/kernels/paged_attn.py``.  The kernel source is
``csrc/paged_attn.cu`` (see its header for what bounds it on Hopper and
what the design does about that).  ``paged_quant_attention`` launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels import loader
from repro_torch.kernels import ref as kref

NEG_INF = -1e30
BIG_WINDOW = 1 << 30

# below this many pages a single split covers the page axis; above, a
# four-way split of each sequence's valid pages (a block has a fixed cost in
# loading its queries and merging its warps, so more, shorter blocks lose)
_SPLIT_MIN_PAGES = 8
DEFAULT_SPLITS = 4


def default_splits(n_pages: int) -> int:
    """Split count for a table width (the split-K config axis)."""
    if n_pages < _SPLIT_MIN_PAGES:
        return 1
    return min(DEFAULT_SPLITS, n_pages)


def _dequant(codes, mu, sigma, kv_bits, dtype):
    k = 2 ** kv_bits
    c = packing.unpack_int4(codes) if kv_bits == 4 else codes
    return kref.kquantile_dequant_ref(
        c, mu.to(torch.float32)[..., None],
        sigma.to(torch.float32)[..., None], k, dtype=dtype)


def paged_quant_attention_plain(q, k_codes, k_mu, k_sigma, v_codes, v_mu,
                                v_sigma, block_tables, q_pos, *, kv_bits: int,
                                window=None, logit_cap=None) -> torch.Tensor:
    """Plain version: gather the block-table rows, dequantize to ``q``'s
    dtype, masked softmax attention of one query position per sequence."""
    B, _, H, D = q.shape
    _, page, KV = k_mu.shape
    G = H // KV
    n_pages = block_tables.shape[1]
    S = n_pages * page
    bt = block_tables.to(torch.long)

    def gather_dequant(codes, mu, sigma):
        c = codes[bt].reshape(B, S, KV, codes.shape[-1])
        m = mu[bt].reshape(B, S, KV)
        s = sigma[bt].reshape(B, S, KV)
        return _dequant(c, m, s, kv_bits, q.dtype)

    k = gather_dequant(k_codes, k_mu, k_sigma)
    v = gather_dequant(v_codes, v_mu, v_sigma)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k.to(torch.float32)) * (D ** -0.5)
    if logit_cap is not None and logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(S, device=q.device)[None]
    qp = q_pos.to(torch.long)[:, None]
    valid = k_pos <= qp
    if window is not None:
        valid &= (qp - k_pos) < window
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    # a fully masked query attends to nothing (the kernel's exact zeros)
    a = torch.where(valid.any(dim=-1)[:, None, None, None], a,
                    torch.zeros_like(a))
    out = torch.einsum("bkgs,bskd->bkgd", a.to(v.dtype), v)
    return out.reshape(B, 1, H, D).to(q.dtype)


_FN = None


def _bind():
    """The kernel's C entry point, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = loader.load("paged_attn").paged_attn_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i] + [p] * 13 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def paged_quant_attention(q: torch.Tensor, k_codes: torch.Tensor,
                          k_mu: torch.Tensor, k_sigma: torch.Tensor,
                          v_codes: torch.Tensor, v_mu: torch.Tensor,
                          v_sigma: torch.Tensor, block_tables: torch.Tensor,
                          q_pos: torch.Tensor, *, kv_bits: int, window=None,
                          logit_cap=None,
                          splits: Optional[int] = None) -> torch.Tensor:
    """q (B, 1, H, D) vs coded pool pages -> (B, 1, H, D).

    k/v_codes : (P, page, KV, D//2) uint8 (kv4) or (P, page, KV, D) int8.
    k/v stats : (P, page, KV) bf16 per-(row, head) mu/sigma.
    block_tables (B, n_pages) int, q_pos (B,) int; rows past q_pos (sink or
    never written) are masked.  ``window``: causal sliding-window width as
    a runtime integer (None or BIG_WINDOW = global), so local and global
    layers share one kernel.  ``splits``: how many blocks share a
    sequence's valid pages; None picks the default for the table width.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``paged_quant_attention.launches`` counts kernel launches.
    """
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_mu.ndim != 3:
        raise ValueError(f"stats must be (P, page, KV), got "
                         f"{tuple(k_mu.shape)}")
    P, page, KV = k_mu.shape
    if D % 2 or H % KV:
        raise ValueError(f"need even D and H % KV == 0, got D={D}, H={H}, "
                         f"KV={KV}")
    code_shape = (P, page, KV, D // 2 if kv_bits == 4 else D)
    want = packing.storage_dtype(kv_bits)
    if not (k_codes.shape == v_codes.shape == code_shape
            and k_codes.dtype == v_codes.dtype == want):
        raise ValueError(f"k/v_codes must be {code_shape} {want}, got "
                         f"{tuple(k_codes.shape)} {k_codes.dtype} and "
                         f"{tuple(v_codes.shape)} {v_codes.dtype}")
    if not (k_sigma.shape == v_mu.shape == v_sigma.shape == k_mu.shape):
        raise ValueError(f"k/v stats must all be {(P, page, KV)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B \
            or q_pos.shape != (B,):
        raise ValueError("block_tables must be (B, n_pages) and q_pos (B,)")
    window_i = BIG_WINDOW if window is None else int(window)
    if window_i < 1:
        raise ValueError(f"window must be >= 1, got {window_i}")
    if q.device.type == "cpu":
        return paged_quant_attention_plain(
            q, k_codes, k_mu, k_sigma, v_codes, v_mu, v_sigma, block_tables,
            q_pos, kv_bits=kv_bits,
            window=None if window_i >= BIG_WINDOW else window_i,
            logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_quant_attention runs on cuda or cpu "
                           f"tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if D > 256 or H // KV > 8 or (D > 128 and H // KV > 4):
        raise ValueError(f"kernel takes D <= 256 and H/KV <= 8 (<= 4 above "
                         f"D = 128), got D={D}, H/KV={H // KV}")
    stats = (k_mu, k_sigma, v_mu, v_sigma)
    if any(t.dtype != torch.bfloat16 for t in stats):
        raise TypeError("k/v stats must be bfloat16")
    for t in (q, k_codes, v_codes) + stats:
        if t.device != q.device:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("q, codes and stats must be contiguous")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    n_pages = bt.shape[1]
    nsplit = default_splits(n_pages) if splits is None else int(splits)
    nsplit = max(1, min(nsplit, n_pages))
    G = H // KV
    fn = _bind()
    table = kref.level_table(2 ** kv_bits, q.device)
    cap = float(logit_cap) if logit_cap is not None and logit_cap > 0 else 0.0
    with loader.on_device(q.device):
        f32 = dict(dtype=torch.float32, device=q.device)
        m_part = torch.empty((B, nsplit, KV, G), **f32)
        l_part = torch.empty((B, nsplit, KV, G), **f32)
        acc_part = torch.empty((B, nsplit, KV, G, D), **f32)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16),
                k_codes.data_ptr(), k_mu.data_ptr(), k_sigma.data_ptr(),
                v_codes.data_ptr(), v_mu.data_ptr(), v_sigma.data_ptr(),
                bt.data_ptr(), qp.data_ptr(), table.data_ptr(),
                m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                out.data_ptr(), B, H, KV, D, page, n_pages, nsplit, kv_bits,
                window_i, cap, stream)
    if rc != 0:
        raise RuntimeError(f"paged_quant_attention kernel launch failed with "
                           f"code {rc} (B={B}, H={H}, KV={KV}, D={D}, "
                           f"page={page}, n_pages={n_pages}, "
                           f"splits={nsplit}, kv_bits={kv_bits})")
    paged_quant_attention.launches += 1
    return out


paged_quant_attention.launches = 0

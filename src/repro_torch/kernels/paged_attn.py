"""Decode attention off the k-quantile-coded paged KV pool: CUDA kernels +
plain PyTorch version.

Replaces the TPU kernel ``paged_quant_attention`` of
``src/repro/kernels/paged_attn.py``.  The kernel source is
``csrc/paged_attn.cu`` (see its header for what bounds it on Hopper and
what the design does about that).  ``paged_quant_attention`` launches a
kernel for CUDA tensors and takes the plain version only for CPU tensors.
Two CUDA bodies, picked by the fixed rule ``attn_route``: the tensor-core
body (``paged_attn_tc_kernel``) for bf16 queries, the engine's, and the
CUDA-core body (``paged_attn_kernel``) for f32 queries and for the few bf16
shapes the tensor-core body does not take.
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


# the tensor-core body: rows per staged chunk (the kernel's TC_ROWS), and
# the SM count its split rule assumes where no device is given (an H100 SXM)
TC_ROWS = 16
H100_SMS = 132

TENSOR_CORE = "tensor_core"
CUDA_CORE = "cuda_core"


def attn_route(q_dtype: torch.dtype, D: int, KV: int, page: int,
               kv_bits: int) -> str:
    """Which CUDA body takes a call: ``TENSOR_CORE`` for bf16 queries,
    ``CUDA_CORE`` for f32 ones.  A fixed rule on the shapes, never on
    whether a build or launch succeeded.  The bf16 shapes the tensor-core
    body does not take, which go to the CUDA-core body:

    - D not a multiple of 16 (one m16n8k16 step is 16 head dims);
    - a page not a multiple of 8 (each chunk's stat arrays are bulk copies
      of rows * KV * 2 bytes, which must be whole 16-byte units);
    - kv4 with D not a multiple of 32 and KV odd (a row's codes of one
      block's heads, ``tc_heads(KV) * D / 2`` bytes, are one bulk copy).
    """
    if q_dtype != torch.bfloat16:
        return CUDA_CORE
    if D % 16 or page % 8:
        return CUDA_CORE
    if kv_bits == 4 and (tc_heads(KV) * D) % 32:
        return CUDA_CORE
    return TENSOR_CORE


def tc_heads(KV: int) -> int:
    """KV heads of one tensor-core block: the largest of 8, 4, 2, 1 that
    divides KV."""
    return next(h for h in (8, 4, 2, 1) if KV % h == 0)


def tc_splits(B: int, n_pages: int, page: int, sms: int = H100_SMS) -> int:
    """Split count of the tensor-core body, from the host-side shapes and
    the card's SM count only (never ``q_pos``, which lives on the device).
    The body runs one block per SM, so the grid aims at one full wave over
    ``sms`` SMs and no more: B * splits <= sms (a partial second wave costs
    a whole block's time), at least one split, at most one chunk of
    ``TC_ROWS`` rows per split of a full table."""
    chunks = n_pages * -(-page // TC_ROWS)
    return max(1, min(chunks, sms // B))


def split_row_ranges(q_pos: int, window: int, page: int, n_pages: int,
                     splits: int):
    """The tensor-core kernel's division of one sequence's rows, in Python:
    for each split, the chunks it walks as (first logical row, end row).

    The valid rows run from the window's start to ``min(q_pos, n_pages *
    page - 1)``.  They are cut into chunks of ``TC_ROWS`` rows aligned to
    their page (the last chunk of a page may be short), numbered across
    pages, and the chunks that hold a valid row are divided evenly among
    the splits.  Rows of a chunk outside the valid range are masked inside
    the kernel.  Mirrors ``paged_attn_tc_kernel`` (``csrc/paged_attn.cu``).
    """
    out = [[] for _ in range(splits)]
    hi = min(q_pos, n_pages * page - 1)
    lo = 0 if window > q_pos else q_pos - window + 1
    if hi < lo:
        return out
    cpp = -(-page // TC_ROWS)

    def index(row):
        return (row // page) * cpp + (row % page) // TC_ROWS

    g_lo, g_hi = index(lo), index(hi)
    per = (g_hi - g_lo + splits) // splits
    for s in range(splits):
        begin = min(g_lo + s * per, g_hi + 1)
        for g in range(begin, min(begin + per, g_hi + 1)):
            j, r0 = g // cpp, (g % cpp) * TC_ROWS
            out[s].append((j * page + r0,
                           j * page + min(r0 + TC_ROWS, page)))
    return out


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


_FN = {}
_ARGTYPES = {
    # q, q_bf16, 13 pointers, 9 ints, cap, stream
    "paged_attn_launch": [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    # 14 pointers, 9 ints, scale, cap, stream
    "paged_attn_tc_launch": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}


def _bind(name: str):
    """A C entry point of the kernel's library, built and bound at first
    use."""
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(loader.load("paged_attn"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


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
    sequence's valid rows; None picks the body's default (``tc_splits``
    for the tensor-core body, ``default_splits`` for the CUDA-core one).

    CUDA tensors launch the body that ``attn_route`` names (or raise); CPU
    tensors take the plain version.  ``paged_quant_attention.launches``
    counts kernel launches.
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
    if (kv_bits == 4 and D % 2) or H % KV:
        raise ValueError(f"need H % KV == 0 and, at kv4 (two codes a "
                         f"byte), an even D; got D={D}, H={H}, KV={KV}")
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
    route = attn_route(q.dtype, D, KV, page, kv_bits)
    if route == TENSOR_CORE and any(t.data_ptr() % 16 for t in
                                    (k_codes, v_codes) + stats):
        raise ValueError("the tensor-core body bulk-copies the pool: codes "
                         "and stats must start 16-byte aligned")
    return _launch(route, q, k_codes, k_mu, k_sigma, v_codes, v_mu, v_sigma,
                   block_tables, q_pos, kv_bits=kv_bits, window=window_i,
                   logit_cap=logit_cap, splits=splits)


paged_quant_attention.launches = 0


def _launch(route: str, q, k_codes, k_mu, k_sigma, v_codes, v_mu, v_sigma,
            block_tables, q_pos, *, kv_bits: int, window: int, logit_cap,
            splits: Optional[int]) -> torch.Tensor:
    """Launch ``route``'s body on checked CUDA operands."""
    B, _, H, D = q.shape
    _, page, KV = k_mu.shape
    # the engine passes int32 contiguous tensors on the card (lm.py's
    # decode_step builds them once per step), and ``.to`` and
    # ``.contiguous`` then return them as they are: no copy per layer
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    n_pages = bt.shape[1]
    tc = route == TENSOR_CORE
    if tc:
        nsplit = tc_splits(B, n_pages, page, loader.sm_count(q.device)) \
            if splits is None else int(splits)
        nsplit = max(1, min(nsplit, n_pages * -(-page // TC_ROWS)))
    else:
        nsplit = default_splits(n_pages) if splits is None else int(splits)
        nsplit = max(1, min(nsplit, n_pages))
    table = kref.level_table(2 ** kv_bits, q.device)
    cap = float(logit_cap) if logit_cap is not None and logit_cap > 0 else 0.0
    with loader.on_device(q.device):
        # the (m, l, acc) partials of every split in one allocation
        n = B * nsplit * H
        buf = loader.empty((n * (D + 2),), torch.float32, q.device,
                           "scratch")
        m_part, l_part, acc_part = buf[:n], buf[n:2 * n], buf[2 * n:]
        out = loader.empty(q.shape, q.dtype, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (k_codes.data_ptr(), k_mu.data_ptr(), k_sigma.data_ptr(),
                 v_codes.data_ptr(), v_mu.data_ptr(), v_sigma.data_ptr(),
                 bt.data_ptr(), qp.data_ptr(), table.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 out.data_ptr())
        if tc:
            rc = _bind("paged_attn_tc_launch")(
                q.data_ptr(), *ptrs, B, H, KV, D, page, n_pages, nsplit,
                kv_bits, window, float(D) ** -0.5, cap, stream)
        else:
            rc = _bind("paged_attn_launch")(
                q.data_ptr(), int(q.dtype == torch.bfloat16), *ptrs, B, H,
                KV, D, page, n_pages, nsplit, kv_bits, window, cap, stream)
    if rc != 0:
        raise RuntimeError(f"paged_quant_attention ({route} body) launch "
                           f"failed with code {rc} (B={B}, H={H}, KV={KV}, "
                           f"D={D}, page={page}, n_pages={n_pages}, "
                           f"splits={nsplit}, kv_bits={kv_bits})")
    paged_quant_attention.launches += 1
    return out

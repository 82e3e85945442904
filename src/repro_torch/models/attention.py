"""Attention: GQA with sliding window, logit soft-capping, paged KV cache.

  * ``full_attention``   — materialized (B, H, Sq, Sk) scores (prefill).
  * ``chunked_attention`` — a loop over KV chunks with an online softmax
    (O(Sq * chunk) live scores); long prefill and training.
  * ``decode_attention`` — one query position against a cache; linear in S.
  * ``paged_*``          — the same math against the page pool, dense or
    k-quantile-coded; the coded decode path is the CUDA kernel of
    ``kernels/paged_attn.py``.

Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D); GQA groups G = H // KV.
``window``: None for global attention, else causal sliding window width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import kquantile as _kq
from repro_torch.kernels import paged_attn as _pa
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30


class AttnParams(NamedTuple):
    window: Optional[int] = None      # sliding-window width (local attention)
    logit_cap: Optional[float] = None # gemma-2 soft-capping
    causal: bool = True


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          p: AttnParams) -> torch.Tensor:
    """(..., Sq, Sk) boolean validity mask from position vectors.

    ``q_pos`` may be (Sq,) — shared by every batch row — or (B, Sq)
    per-sequence positions (coalesced chunked prefill); ``k_pos`` is (Sk,).
    """
    qp = q_pos[..., :, None]
    m = torch.ones(qp.shape[:-1] + (k_pos.shape[-1],), dtype=torch.bool,
                   device=k_pos.device)
    if p.causal:
        m &= qp >= k_pos
    if p.window is not None:
        m &= qp - k_pos < p.window
    return m


def _scores(q, k, p: AttnParams) -> torch.Tensor:
    """q (B, Sq, H, D) x k (B, Sk, KV, D) -> (B, H, Sq, Sk) f32 logits."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32))
    s = s * (D ** -0.5)
    s = _softcap(s, p.logit_cap)
    return s.reshape(B, H, Sq, k.shape[1])


def _attend(q, k, v, mask, p: AttnParams) -> torch.Tensor:
    """Materialized-scores attention under a validity mask of shape
    (Sq, Sk) (shared) or (B, Sq, Sk) (per-sequence positions)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    s = _scores(q, k, p)                                  # (B,H,Sq,Sk) f32
    if mask.ndim == 2:
        mask = mask[None]
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1).to(v.dtype)
    a = a.reshape(B, KV, G, Sq, k.shape[1])
    out = torch.einsum("bkgqs,bskd->bqkgd", a, v)
    return out.reshape(B, Sq, H, D)


def full_attention(q, k, v, q_pos, k_pos, p: AttnParams) -> torch.Tensor:
    """Materialized-scores attention.  positions: (Sq,) (or (B, Sq) for
    per-sequence chunk offsets), (Sk,) int."""
    return _attend(q, k, v, _mask(q_pos, k_pos, p), p)


def chunked_attention(q, k, v, q_pos, k_pos, p: AttnParams,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style), in f32.

    The reference's math step for step: the queries scaled by D^-0.5 in f32
    first, per chunk the capped logits, the masked running max, its
    rescale of ``(l, acc)``; rows whose every key so far is masked keep a
    finite max (``m_safe``).  ``Sk % kv_chunk != 0`` falls back to one
    chunk.  Positions as ``full_attention``'s."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sk % kv_chunk:
        kv_chunk = Sk                                     # one chunk
    f32 = torch.float32
    # (B, KV, G, Sq, D): one layout copy, then a batched matmul per chunk
    qg = (q.to(f32) * (D ** -0.5)).reshape(B, Sq, KV, G, D).permute(
        0, 2, 3, 1, 4)
    m = torch.full((B, KV, G, Sq), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=f32, device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].to(f32).permute(0, 2, 3, 1)[:, :, None]
        vb = v[:, c0:c0 + kv_chunk].to(f32).permute(0, 2, 1, 3)[:, :, None]
        s = _softcap(torch.matmul(qg, kb), p.logit_cap)   # (B,KV,G,Sq,kc)
        mask = _mask(q_pos, k_pos[c0:c0 + kv_chunk], p)
        mask = mask[:, None, None] if mask.ndim == 3 else mask
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        pexp = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(pexp, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)      # (B,KV,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, p: AttnParams, opts) -> torch.Tensor:
    """Self-attention over a whole sequence as the models take it: chunked
    from S = ``opts.attn_chunked_min_len`` on (KV chunks of
    ``opts.kv_chunk``), materialized below."""
    if q.shape[1] >= opts.attn_chunked_min_len:
        return chunked_attention(q, k, v, q_pos, k_pos, p,
                                 kv_chunk=opts.kv_chunk)
    return full_attention(q, k, v, q_pos, k_pos, p)


def decode_attention(q, k_cache, v_cache, q_pos, p: AttnParams):
    """Single-position decode: q (B, 1, H, D) vs cache (B, S, KV, D).

    q_pos: (B,) current positions.  Keys at positions > q_pos (or outside
    the sliding window) are masked; the cache may be longer than the valid
    prefix.
    """
    B, _, H, D = q.shape
    S = k_cache.shape[1]
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * (D ** -0.5)
    s = _softcap(s, p.logit_cap)
    k_pos = torch.arange(S, device=q.device)[None]        # (1, S)
    valid = k_pos <= q_pos[:, None]
    if p.window is not None:
        valid &= (q_pos[:, None] - k_pos) < p.window
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", a, v_cache)
    return out.reshape(B, 1, H, D)


def paged_decode_attention(q, k_pages, v_pages, block_tables, q_pos,
                           p: AttnParams) -> torch.Tensor:
    """Decode attention against a dense paged KV pool.

    k/v_pages (P, page, KV, D); block_tables (B, n_pages) page ids, entries
    past the allocated prefix point at the sink page 0 and are masked by
    position; q_pos (B,).  The gathered view is position-contiguous, so
    the masked ``decode_attention`` applies unchanged.
    """
    k = _kq.gather_pages(k_pages, block_tables)
    v = _kq.gather_pages(v_pages, block_tables)
    return decode_attention(q, k, v, q_pos, p)


def paged_decode_attention_quant(q, cache, block_tables, q_pos,
                                 p: AttnParams, *, kv_bits: int,
                                 use_kernel: bool = True) -> torch.Tensor:
    """Decode attention against a k-quantile-coded paged KV pool.

    cache: one layer's slice of the pool — {"k_codes","v_codes"}
    (P, page, KV, D') and {"k_mu","k_sigma","v_mu","v_sigma"} (P, page, KV)
    bf16.  On CUDA tensors this launches the paged-attention kernel; on CPU
    tensors its plain version.  ``use_kernel=False`` is the comparison
    hook: the plain version on whatever device the tensors are on.
    """
    fn = _pa.paged_quant_attention if use_kernel \
        else _pa.paged_quant_attention_plain
    return fn(q, cache["k_codes"], cache["k_mu"], cache["k_sigma"],
              cache["v_codes"], cache["v_mu"], cache["v_sigma"],
              block_tables, q_pos, kv_bits=kv_bits, window=p.window,
              logit_cap=p.logit_cap)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, q_pos,
                            p: AttnParams) -> torch.Tensor:
    """Multi-token (chunked) prefill attention against a dense paged pool.

    q (B, C, H, D); the chunk's own rows must already be scattered in
    (write-before-read); q_pos (C,) or (B, C) absolute positions.
    """
    k = _kq.gather_pages(k_pages, block_tables)
    v = _kq.gather_pages(v_pages, block_tables)
    k_pos = torch.arange(k.shape[1], device=q.device)
    return full_attention(q, k.to(q.dtype), v.to(q.dtype), q_pos, k_pos, p)


def paged_prefill_attention_quant(q, cache, block_tables, q_pos,
                                  p: AttnParams, *, kv_bits: int,
                                  use_kernel: bool = True) -> torch.Tensor:
    """Chunked-prefill attention against a k-quantile-coded paged pool:
    reads the block-table row densely, gathered and dequantized in one
    ``kquantile_dequantize_paged`` launch for K and one for V on CUDA
    tensors, and defers to ``full_attention`` — what whole prefill sees
    after ``fake_quant_kv``.  ``use_kernel=False`` is the comparison hook:
    the plain version (gathers, casts, dequantize) on whatever device the
    tensors are on."""
    read = _kq.kquantile_dequantize_paged if use_kernel \
        else _kq.kquantile_dequantize_paged_plain

    def dequant(side):
        return read(cache[f"{side}_codes"], cache[f"{side}_mu"],
                    cache[f"{side}_sigma"], block_tables, kv_bits=kv_bits,
                    out_dtype=q.dtype)

    k, v = dequant("k"), dequant("v")
    k_pos = torch.arange(k.shape[1], device=q.device)
    return full_attention(q, k, v, q_pos, k_pos, p)

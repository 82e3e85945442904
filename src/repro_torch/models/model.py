"""Unified model API for the decoder families ported so far (dense, moe).

    init(seed, cfg, device)             -> params
    loss_fn(params, cfg, opts, batch)   -> scalar loss          (train)
    prefill(params, cfg, opts, batch)   -> (logits, cache)
    decode(params, cfg, opts, cache, tokens, positions, block_tables)
                                        -> (logits, cache)

and the two serving caches: the slot cache (``init_slot_cache`` /
``cache_insert``: one fixed region of ``max_len`` rows per decode slot) and
the paged pool (``init_paged_cache`` / ``cache_insert_paged``).  The
families ssm, hybrid, audio and vlm are registered (``configs/``) but not
ported: every entry point raises ``NotImplementedError`` naming the family
(``require_ported``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.lm import ModelOpts

__all__ = ["ModelOpts", "init", "loss_fn", "prefill", "decode",
           "quantize_for_serving", "cache_specs", "init_cache",
           "supports_slot_cache", "init_slot_cache", "cache_insert",
           "supports_paged_cache", "init_paged_cache", "cache_insert_paged",
           "prefill_chunk", "PORTED_FAMILIES", "require_ported"]

# the families whose model this package has; the reference's registry also
# holds ssm (mamba2), hybrid (zamba2), audio (whisper) and vlm (pixtral)
PORTED_FAMILIES = ("dense", "moe")


def supports_paged_cache(cfg: ArchConfig) -> bool:
    """Paged-cache serving covers the plain-KV decoder families, dense and
    moe, as in the reference."""
    return cfg.family in ("dense", "moe")


def require_ported(cfg: ArchConfig, what: str) -> None:
    """Raise NotImplementedError, naming the family, for a family this
    package has no model of yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


def init(seed: int, cfg: ArchConfig, device="cuda", **kw) -> Any:
    """Random parameters from ``seed`` (see lm.init_params: ``w_bits`` /
    ``w_dist`` code them layer by layer, ``dense_dtype``,
    ``per_channel``)."""
    require_ported(cfg, "init")
    return lm.init_params(seed, cfg, device=device, **kw)


def loss_fn(params, cfg: ArchConfig, opts: ModelOpts, batch,
            uniq_scan=None) -> torch.Tensor:
    """Teacher-forced LM loss (see lm.forward_train)."""
    require_ported(cfg, "loss_fn")
    return lm.forward_train(params, cfg, opts, batch, uniq_scan=uniq_scan)


def prefill(params, cfg: ArchConfig, opts: ModelOpts, batch, last_idx=None):
    """``last_idx`` (B,) selects per-sequence last positions for padded
    batched prefill (see lm.forward_prefill)."""
    require_ported(cfg, "prefill")
    return lm.forward_prefill(params, cfg, opts, batch, last_idx=last_idx)


def decode(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
           positions, block_tables=None):
    """One decode step against the slot cache (no ``block_tables``) or the
    paged pool (see lm.decode_step)."""
    require_ported(cfg, "decode")
    return lm.decode_step(params, cfg, opts, cache, tokens, positions,
                          block_tables=block_tables)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """Shapes and dtypes of the KV cache of ``batch`` sequences of
    ``max_len`` rows, as ``device="meta"`` tensors (see lm.cache_specs).
    The reference takes a ``ShapeConfig``; the port takes its batch and
    sequence length."""
    require_ported(cfg, "cache_specs")
    return lm.cache_specs(cfg, batch, max_len, dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zeroed KV cache (L, batch, max_len, KV, hd) (see lm.init_cache)."""
    require_ported(cfg, "init_cache")
    return lm.init_cache(cfg, batch, max_len, dtype, device=device)


def supports_slot_cache(cfg: ArchConfig) -> bool:
    """Slot-cache serving covers the families whose cache is the plain
    (L, B, S, KV, hd) KV layout written positionally by lm.decode_step,
    as in the reference: dense and moe."""
    return cfg.family in ("dense", "moe")


def init_slot_cache(cfg: ArchConfig, max_slots: int, max_len: int,
                    dtype=torch.bfloat16, device="cuda"):
    """Zeroed slot cache: one fixed (max_len) KV region per decode slot."""
    if not supports_slot_cache(cfg):
        raise ValueError(f"slot cache unsupported for family {cfg.family}")
    return lm.init_cache(cfg, max_slots, max_len, dtype, device=device)


@torch.no_grad()
def cache_insert(cache, prefill_cache, slots):
    """Write a prefill KV block into decode slots, in place.

    cache          : {"k","v"} (L, max_slots, max_len, KV, hd)
    prefill_cache  : {"k","v"} (L, G, S_pad, KV, hd) from a (padded)
                     batched prefill of G admitted prompts
    slots          : (G,) destination slot ids

    Rows ``[:S_pad]`` of each slot are overwritten, cast to the cache's
    dtype.  Rows past a prompt's true length hold right-padding garbage,
    but they are never attended: decode at position t masks keys to
    k_pos <= t and overwrites row t before attending, so every visible row
    has been written by either the prompt prefix or an earlier decode
    step.  A slot named twice (the engine pads a group with copies of its
    first row) is written twice with the same rows.
    """
    s_pad = prefill_cache["k"].shape[2]
    slots = torch.as_tensor(slots, device=cache["k"].device).to(torch.long)
    for name in ("k", "v"):
        cache[name][:, slots, :s_pad] = prefill_cache[name].to(
            cache[name].dtype)
    return cache


def init_paged_cache(cfg: ArchConfig, total_pages: int, page_size: int,
                     dtype=torch.bfloat16, kv_bits: int = 16, device="cuda"):
    """Zeroed paged KV pool (page 0 is the reserved sink; see
    lm.init_paged_cache and models/kv_cache.py)."""
    require_ported(cfg, "paged cache")
    return lm.init_paged_cache(cfg, total_pages, page_size, dtype,
                               kv_bits=kv_bits, device=device)


def cache_insert_paged(cache, prefill_cache, page_tables):
    """Scatter a batched-prefill KV block into pool pages, in place."""
    return lm.cache_insert_paged(cache, prefill_cache, page_tables)


def prefill_chunk(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                  positions, write_pages, write_rows, block_tables,
                  last_idx):
    """Run the next chunk of prompt tokens against (and into) the paged
    pool (see lm.prefill_chunk)."""
    require_ported(cfg, "chunked prefill")
    return lm.prefill_chunk(params, cfg, opts, cache, tokens, positions,
                            write_pages, write_rows, block_tables, last_idx)


def quantize_for_serving(params, bits: int, per_channel: bool = True,
                         dist: str = "gaussian", device="cuda"):
    """k-quantile-code all matmul weights for the serving path (UNIQ):
    Gaussian levels, or with dist="empirical" per-tensor empirical
    codebooks."""
    return lm.quantize_params_for_serving(params, bits,
                                          per_channel=per_channel,
                                          dist=dist, device=device)

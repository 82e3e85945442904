"""Unified model API over every family of the registry: the decoder-only
LMs (dense, moe, vlm: ``models/lm.py``), the state-space families (ssm:
mamba2, hybrid: zamba2; ``models/hybrid.py``) and the encoder-decoder
(audio: whisper; ``models/encdec.py``).

    init(seed, cfg, device)             -> params
    loss_fn(params, cfg, opts, batch)   -> scalar loss   (train)
    prefill(params, cfg, opts, batch)   -> (logits, cache)
    decode(params, cfg, opts, cache, tokens, positions, block_tables)
                                        -> (logits, cache)

and the serving caches: each family's decode cache (``init_cache`` /
``cache_specs``), the slot cache (``init_slot_cache`` / ``cache_insert``:
one fixed region of ``max_len`` rows per decode slot) and the paged pool
(``init_paged_cache`` / ``cache_insert_paged``); the last two hold the
plain KV layout of dense and moe only.  A family outside
``PORTED_FAMILIES`` raises ``NotImplementedError`` naming it
(``require_ported``).  On a mesh the dense and vlm decoders run on placed
parameters (``parallel/tensor_parallel.py``: ``opts.placement``), the MoE
family expert-parallel (``opts.moe_axis``); the state-space and audio
families raise naming the model (``require_mesh_ported``).
"""

from __future__ import annotations

from typing import Any

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, lm
from repro_torch.models.lm import ModelOpts
from repro_torch.parallel.sharding import axis_sizes

__all__ = ["ModelOpts", "init", "loss_fn", "prefill", "decode",
           "quantize_for_serving", "cache_specs", "init_cache",
           "supports_slot_cache", "init_slot_cache", "cache_insert",
           "supports_paged_cache", "init_paged_cache", "cache_insert_paged",
           "prefill_chunk", "PORTED_FAMILIES", "require_ported",
           "require_mesh_ported"]

# the families whose model this package has: every one of the registry
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the state-space families: closed-batch serving and training, their caches
# a conv window and an SSM state per layer (and the shared block's K/V at
# hybrid)
SSM_FAMILIES = ("ssm", "hybrid")


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


# the families that run on a mesh's placed parameters (tensor and FSDP
# parallelism, parallel/tensor_parallel.py)
PLACED_FAMILIES = ("dense", "vlm")


def require_mesh_ported(cfg: ArchConfig, opts: ModelOpts, what: str) -> None:
    """Check a model against ``opts.mesh`` where it has more than one rank
    on the axes the caller does not split itself (``opts.manual_axes``).
    The state-space and audio families raise NotImplementedError naming
    the model: their tensor and FSDP parallelism is not ported, and each
    rank would otherwise compute the whole model alone.  The dense and vlm
    decoders need placed parameters (``opts.placement``, from
    ``tensor_parallel.place_params``), the MoE family ``opts.moe_axis``
    (its expert layers split over the mesh, the others whole on every
    rank): either missing raises ValueError."""
    if opts.mesh is None:
        return
    sizes = axis_sizes(opts.mesh)
    ranks = math.prod(n for a, n in sizes.items()
                      if a not in opts.manual_axes)
    if cfg.family in PLACED_FAMILIES:
        if ranks > 1 and opts.placement is None:
            raise ValueError(
                f"{what}: {cfg.name} on a {sizes} mesh needs its "
                f"parameters placed (tensor_parallel.place_params)")
        return
    if cfg.is_moe:
        if ranks > 1 and not opts.moe_axis:
            raise ValueError(f"{what}: {cfg.name} on a {sizes} mesh runs "
                             f"expert-parallel (moe_axis='model')")
        return
    if ranks > 1:
        raise NotImplementedError(
            f"{what}: {cfg.name} ({cfg.family}) on a {sizes} mesh: the "
            f"tensor / FSDP parallelism of its layers over {ranks} ranks "
            f"is not ported (the dense and vlm decoders and the "
            f"expert-parallel MoE split over a mesh)")


def init(seed: int, cfg: ArchConfig, device="cuda", **kw) -> Any:
    """Random parameters from ``seed``; every family takes ``w_bits`` /
    ``w_dist`` (code the weights layer by layer) and ``dense_dtype``, and
    dense, moe and vlm also ``per_channel`` (see lm.init_params)."""
    require_ported(cfg, "init")
    if cfg.family in SSM_FAMILIES:
        return hybrid.init_params(seed, cfg, device=device, **kw)
    if cfg.family == "audio":
        return encdec.init_params(seed, cfg, device=device, **kw)
    return lm.init_params(seed, cfg, device=device, **kw)


def loss_fn(params, cfg: ArchConfig, opts: ModelOpts, batch,
            uniq_scan=None) -> torch.Tensor:
    """Teacher-forced LM loss: encdec.forward_train (audio; the batch holds
    ``frames`` beside the tokens), hybrid.forward_train (ssm, hybrid) or
    lm.forward_train (dense, moe, vlm with ``patch_embeds``).
    ``uniq_scan = (UniqConfig, (L,) modes, noise)`` applies the UNIQ
    transform per layer inside the layer loop (the decoder families: the
    others raise ValueError, as no train step hands them one)."""
    require_ported(cfg, "loss_fn")
    require_mesh_ported(cfg, opts, "loss_fn")
    if cfg.family in SSM_FAMILIES + ("audio",):
        if uniq_scan is not None:
            raise ValueError(
                f"uniq_scan: family {cfg.family!r} takes the whole-tree "
                f"transform (the per-layer one covers dense, moe and vlm)")
        forward = encdec.forward_train if cfg.family == "audio" \
            else hybrid.forward_train
        return forward(params, cfg, opts, batch)
    return lm.forward_train(params, cfg, opts, batch, uniq_scan=uniq_scan)


def prefill(params, cfg: ArchConfig, opts: ModelOpts, batch, last_idx=None):
    """``last_idx`` (B,) selects per-sequence last positions for padded
    batched prefill (decoder-only KV families; see lm.forward_prefill).
    The audio family's batch holds ``frames`` (B, Te, d) beside the
    tokens, the vlm's ``patch_embeds`` (B, P, d)."""
    require_ported(cfg, "prefill")
    require_mesh_ported(cfg, opts, "prefill")
    if cfg.family in SSM_FAMILIES + ("audio",):
        if last_idx is not None:
            raise ValueError(
                f"last_idx is unsupported for family {cfg.family}: padded "
                "batched prefill only covers decoder-only KV families")
        if cfg.family == "audio":
            return encdec.forward_prefill(params, cfg, opts, batch)
        return hybrid.prefill(params, cfg, opts, batch)
    return lm.forward_prefill(params, cfg, opts, batch, last_idx=last_idx)


def decode(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
           positions, block_tables=None):
    """One decode step against the family's cache: the slot cache (no
    ``block_tables``) or the paged pool (dense, moe; see lm.decode_step),
    the state caches of hybrid.decode_step or the self and cross K/V of
    encdec.decode_step."""
    require_ported(cfg, "decode")
    require_mesh_ported(cfg, opts, "decode")
    if block_tables is not None and not supports_paged_cache(cfg):
        raise ValueError(f"paged decode unsupported for family {cfg.family}")
    if cfg.family in SSM_FAMILIES:
        return hybrid.decode_step(params, cfg, opts, cache, tokens,
                                  positions)
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, opts, cache, tokens,
                                  positions)
    return lm.decode_step(params, cfg, opts, cache, tokens, positions,
                          block_tables=block_tables)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """Shapes and dtypes of the decode cache of ``batch`` sequences of
    ``max_len`` rows, as ``device="meta"`` tensors (see lm.cache_specs,
    hybrid.cache_specs, encdec.cache_specs; mamba2's ignores ``max_len``,
    whisper's self and cross K/V take ``max_len // 2`` rows each).  The
    reference takes a ``ShapeConfig``; the port takes its batch and
    sequence length."""
    require_ported(cfg, "cache_specs")
    if cfg.family in SSM_FAMILIES:
        return hybrid.cache_specs(cfg, batch, max_len, dtype)
    if cfg.family == "audio":
        return encdec.cache_specs(cfg, batch, max_len, dtype)
    return lm.cache_specs(cfg, batch, max_len, dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", opts=None):
    """Zeroed decode cache: KV (L, batch, max_len, KV, hd) (see
    lm.init_cache; on a mesh, ``opts.placement``, the rank's rows and KV
    heads), the state caches of hybrid.init_cache (mamba2's ignores
    ``max_len``) or encdec.init_cache's self and cross K/V of
    ``max_len // 2`` rows each."""
    require_ported(cfg, "init_cache")
    if opts is not None:
        require_mesh_ported(cfg, opts, "init_cache")
    if cfg.family in SSM_FAMILIES:
        return hybrid.init_cache(cfg, batch, max_len, dtype, device=device)
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, max_len, dtype, device=device)
    return lm.init_cache(cfg, batch, max_len, dtype, device=device,
                         opts=opts)


def supports_slot_cache(cfg: ArchConfig) -> bool:
    """Slot-cache serving covers the families whose cache is the plain
    (L, B, S, KV, hd) KV layout written positionally by lm.decode_step,
    as in the reference: dense and moe."""
    return cfg.family in ("dense", "moe")


def init_slot_cache(cfg: ArchConfig, max_slots: int, max_len: int,
                    dtype=torch.bfloat16, device="cuda", opts=None):
    """Zeroed slot cache: one fixed (max_len) KV region per decode slot
    (on a mesh, ``opts.placement``, the rank's slots and KV heads)."""
    if not supports_slot_cache(cfg):
        raise ValueError(f"slot cache unsupported for family {cfg.family}")
    return lm.init_cache(cfg, max_slots, max_len, dtype, device=device,
                         opts=opts)


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
                     dtype=torch.bfloat16, kv_bits: int = 16, device="cuda",
                     opts=None):
    """Zeroed paged KV pool (page 0 is the reserved sink; see
    lm.init_paged_cache and models/kv_cache.py; on a mesh,
    ``opts.placement``, the KV heads the rank attends)."""
    require_ported(cfg, "paged cache")
    if not supports_paged_cache(cfg):
        raise ValueError(f"paged cache unsupported for family {cfg.family}")
    return lm.init_paged_cache(cfg, total_pages, page_size, dtype,
                               kv_bits=kv_bits, device=device, opts=opts)


def cache_insert_paged(cache, prefill_cache, page_tables):
    """Scatter a batched-prefill KV block into pool pages, in place."""
    return lm.cache_insert_paged(cache, prefill_cache, page_tables)


def prefill_chunk(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                  positions, write_pages, write_rows, block_tables,
                  last_idx):
    """Run the next chunk of prompt tokens against (and into) the paged
    pool (see lm.prefill_chunk)."""
    require_ported(cfg, "chunked prefill")
    require_mesh_ported(cfg, opts, "chunked prefill")
    if not supports_paged_cache(cfg):
        raise ValueError(
            f"chunked prefill unsupported for family {cfg.family}")
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

"""Mamba-2 (ssm) and Zamba2 (hybrid) model assemblies: parameters, the
training forward, prefill, the decode caches and the decode step.

mamba2  : a stack of Mamba-2 blocks (attention-free; decode state O(1)).
zamba2  : a Mamba-2 backbone with one *weight-shared* attention + MLP block
          applied after every ``attn_every`` Mamba layers (9 applications
          for 54 / 6).  As in the reference, the real model's per-invocation
          LoRA deltas and embedding-concat input are omitted: pure weight
          sharing with standard residuals.

Every per-layer Mamba parameter carries a leading (L,) axis; one layer
loop serves both families, over layer views (``lm._layer``: a stacked
tree or the per-layer list of ``lm.unstack_layers``), with zamba2's shared
block after every ``attn_every``-th layer.  Coded projections (``in_proj``,
``out_proj``, the shared block's seven matrices, the LM head) go through
``lm.mm``: the ``qmatmul`` / ``qmatmul_lut`` kernel on the card.  The
decode caches are updated in place: the conv window (L, B, d_conv-1,
conv_channels) in the cache dtype, the SSM state (L, B, nh, hd, n) always
f32, and at zamba2 the shared block's dense K/V (groups, B, max_len, KV,
hd), read by ``attention.decode_attention`` (no paged pool).

As in the reference, ``opts.a_bits`` fake-quantizes each Mamba layer's
output in training and at prefill only: the decode steps leave it alone.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.lm import ModelOpts, mm


def ssm_dims(cfg: ArchConfig) -> ssm_lib.SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    return ssm_lib.SSMDims(
        d_model=cfg.d_model, d_inner=d_inner,
        n_heads=d_inner // cfg.ssm_headdim, headdim=cfg.ssm_headdim,
        state=cfg.ssm_state, d_conv=cfg.ssm_dconv)


def _init_mamba_layers(weight, gen: torch.Generator, dev, cfg: ArchConfig,
                       L: int) -> Dict[str, Any]:
    """The stacked Mamba leaves.  ``weight`` is ``lm.weight_drawer``'s:
    ``in_proj`` / ``out_proj`` are drawn (and coded) a layer at a time; the
    small SSM leaves stay f32, as the reference computes with them."""
    dims = ssm_dims(cfg)
    nh = dims.n_heads
    f32 = dict(dtype=torch.float32, device=dev)
    in_proj = weight("layers/in_proj", (L, cfg.d_model, dims.in_proj_out),
                     dense_init, True)
    conv_w = weight("layers/conv_w", (L, dims.conv_channels, dims.d_conv),
                    dense_init, True, dtype=torch.float32, in_axis=-1)
    # dt bias initialised so softplus(dt) spans ~[1e-3, 1e-1] (mamba conv.)
    lo, hi = math.log(0.001), math.log(0.1)
    u = torch.rand((L, nh), generator=gen, **f32)
    dt = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    out_proj = weight("layers/out_proj", (L, dims.d_inner, cfg.d_model),
                      dense_init, True)
    A = torch.arange(1, nh + 1, **f32).expand(L, nh)
    return {
        "pre_norm": torch.ones((L, cfg.d_model), **f32),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((L, dims.conv_channels), **f32),
        "dt_bias": dt_bias,
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((L, nh), **f32),
        "norm_scale": torch.ones((L, dims.d_inner), **f32),
        "out_proj": out_proj,
    }


def _mamba_layer_apply(x, lp, cfg: ArchConfig, opts: ModelOpts):
    """Pre-norm, the Mamba-2 block, the residual and the layer-output
    fake-quant (prefill); returns (x, (conv window, SSM state))."""
    h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
    y, conv_c, ssm_c = ssm_lib.mamba2_block(
        h, lp, ssm_dims(cfg), chunk=opts.ssd_chunk, state_out=True,
        use_kernels=opts.use_kernels)
    return lm._maybe_quant_act(x + y, opts), (conv_c, ssm_c)


def _mamba_layer_decode(h, lp, cfg: ArchConfig, opts: ModelOpts, cache,
                        l: int):
    """One token through Mamba layer ``l``, its cache rows written in
    place; no fake-quant (the reference's decode has none)."""
    hn = rms_norm(h, lp["pre_norm"], cfg.norm_eps)
    y, conv_c, ssm_c = ssm_lib.mamba2_decode(
        hn, lp, ssm_dims(cfg), cache["conv"][l], cache["ssm"][l],
        use_kernels=opts.use_kernels)
    cache["conv"][l].copy_(conv_c)
    cache["ssm"][l].copy_(ssm_c)
    return h + y


def _final_logits(x, params, cfg: ArchConfig, opts: ModelOpts):
    """Final norm, then (B, V) f32 logits of the (B, d) rows ``x``."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm._logits(x, params, cfg, opts)


def _shared_after(cfg: ArchConfig, l: int) -> bool:
    """Whether the shared block follows Mamba layer ``l`` (zamba2: after
    every ``attn_every`` layers; mamba2 has no shared block)."""
    return cfg.family == "hybrid" and (l + 1) % cfg.attn_every == 0


@torch.no_grad()
def init_params(seed: int, cfg: ArchConfig, device="cuda", w_bits: int = 16,
                dense_dtype=torch.float32,
                w_dist: str = "gaussian") -> Dict[str, Any]:
    """Random mamba2 / zamba2 parameter tree on ``device`` from ``seed``
    (the reference's ``init_params_mamba`` / ``_zamba``), drawn (and with
    ``w_bits`` 4 / 8 coded) as ``lm.init_params`` draws its own: the
    embedding, the Mamba stack, at zamba2 the shared attention + MLP block
    (``shared``, coded unstacked), the LM head."""
    weight, gen, dev = lm.weight_drawer(seed, device, w_bits, dense_dtype,
                                        w_dist=w_dist)
    d = cfg.d_model
    params = {"embed": weight("embed", (cfg.vocab, d), embed_init, False),
              "layers": _init_mamba_layers(weight, gen, dev, cfg,
                                           cfg.n_layers)}
    ones = torch.ones((d,), dtype=torch.float32, device=dev)
    if cfg.family == "hybrid":
        H, KV, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        shared = {"attn_norm": ones.clone()}
        for name, shape in (("wq", (d, H * hd)), ("wk", (d, KV * hd)),
                            ("wv", (d, KV * hd)), ("wo", (H * hd, d))):
            shared[name] = weight(f"shared/{name}", shape, dense_init, False)
        shared["mlp_norm"] = ones.clone()
        for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                            ("w_down", (f, d))):
            shared[name] = weight(f"shared/{name}", shape, dense_init, False)
        params["shared"] = shared
    params["final_norm"] = ones
    params["lm_head"] = weight("lm_head", (d, cfg.vocab), dense_init, False)
    return params


def _shared_mlp(x, sp, cfg: ArchConfig, opts: ModelOpts):
    hm = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    g = F.silu(mm(hm, sp["w_gate"], opts.use_kernels)) \
        * mm(hm, sp["w_up"], opts.use_kernels)
    return x + mm(g, sp["w_down"], opts.use_kernels)


def _shared_attn_apply(x, sp, cfg: ArchConfig, opts: ModelOpts, positions,
                       cos_sin):
    """The shared attention + MLP block on (B, S, d) (causal, global, no
    logit cap; chunked from S = ``opts.attn_chunked_min_len`` on).  Returns
    (x, (k, v))."""
    B, S, _ = x.shape
    h = rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    q, k, v = lm._qkv_mm(h, sp, cfg, opts, positions, cos_sin)
    p = attn.AttnParams(window=None, logit_cap=None, causal=True)
    pos1d = positions[0]
    o = attn.attend(q, k, v, pos1d, pos1d, p, opts)
    x = x + mm(o.reshape(B, S, cfg.n_heads * cfg.head_dim), sp["wo"],
               opts.use_kernels)
    return _shared_mlp(x, sp, cfg, opts), (k, v)


def forward_train(params, cfg: ArchConfig, opts: ModelOpts, batch):
    """Teacher-forced LM loss (the reference's ``forward_train_mamba`` /
    ``forward_train_zamba``): the Mamba stack (each layer's output
    fake-quantized at ``opts.a_bits`` < 32), at zamba2 the shared block
    after every ``attn_every``-th layer, the final norm and the chunked
    cross-entropy on the LM head.  With ``opts.remat`` each Mamba layer is
    recomputed in the backward pass; the shared block is not, as the
    reference wraps only its inner Mamba layers."""
    if not isinstance(params["layers"], list):
        params = lm.unstack_layers(params, cfg.n_layers)
    x = lm._embed_tokens(params, cfg, opts, batch["tokens"])
    if cfg.family == "hybrid":
        positions, cos_sin = lm.rope_positions(*x.shape[:2], cfg, x.device)
    for l in range(cfg.n_layers):
        x, _ = lm.apply_layer(_mamba_layer_apply, opts.remat, x,
                              lm._layer(params, l), cfg, opts)
        if _shared_after(cfg, l):
            x, _ = _shared_attn_apply(x, params["shared"], cfg, opts,
                                      positions, cos_sin)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm.chunked_ce_loss(x, params["lm_head"], batch["targets"], cfg,
                              opts)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, opts: ModelOpts, batch):
    """Run the prompt through the stack (the reference's ``prefill_mamba``
    / ``prefill_zamba``): last-token logits (B, V) f32 and the decode
    cache: per layer the (conv window, SSM state), and at zamba2 the
    shared block's K/V of each application ((groups, B, S, KV, hd))."""
    x = lm._embed_tokens(params, cfg, opts, batch["tokens"])
    if cfg.family == "hybrid":
        positions, cos_sin = lm.rope_positions(*x.shape[:2], cfg, x.device)
    convs, ssms, ks, vs = [], [], [], []
    for l in range(cfg.n_layers):
        x, (conv_c, ssm_c) = _mamba_layer_apply(x, lm._layer(params, l), cfg,
                                                opts)
        convs.append(conv_c)
        ssms.append(ssm_c)
        if _shared_after(cfg, l):
            x, (k, v) = _shared_attn_apply(x, params["shared"], cfg, opts,
                                           positions, cos_sin)
            ks.append(k)
            vs.append(v)
    logits = _final_logits(x[:, -1], params, cfg, opts)
    cache = {"conv": torch.stack(convs).to(x.dtype),
             "ssm": torch.stack(ssms)}
    if ks:
        cache["k"] = torch.stack(ks).to(x.dtype)
        cache["v"] = torch.stack(vs).to(x.dtype)
    return logits, cache


@torch.no_grad()
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode cache: the conv window (L, batch, d_conv-1,
    conv_channels) in ``dtype``, the SSM state (L, batch, nh, hd, n) f32,
    and at zamba2 the shared block's K/V (groups, batch, max_len, KV, hd)
    in ``dtype`` (mamba2's ignores ``max_len``)."""
    dev = resolve_device(device)
    dims = ssm_dims(cfg)
    L = cfg.n_layers
    cache = {"conv": torch.zeros((L, batch, dims.d_conv - 1,
                                  dims.conv_channels), dtype=dtype,
                                 device=dev),
             "ssm": torch.zeros((L, batch, dims.n_heads, dims.headdim,
                                 dims.state), dtype=torch.float32,
                                device=dev)}
    if cfg.family == "hybrid":
        shape = (L // cfg.attn_every, batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """The cache's shapes and dtypes as ``device="meta"`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                positions):
    """One decode step (the reference's ``decode_step_mamba`` /
    ``decode_step_zamba``): tokens (B, 1), positions (B,) (read by zamba2's
    shared block only: the SSM state is O(1)).  At zamba2 the shared
    block's fresh K/V row is written at each row's position of its group's
    cache before it attends.  Returns (logits (B, V) f32, the cache,
    updated in place)."""
    dev = cache["ssm"].device
    x = lm._embed_tokens(params, cfg, opts,
                         torch.as_tensor(tokens, device=dev))  # (B, 1, d)
    B = x.shape[0]
    if cfg.family == "hybrid":
        H, hd = cfg.n_heads, cfg.head_dim
        sp = params["shared"]
        positions = torch.as_tensor(positions, device=dev).to(torch.long)
        pos2d = positions[:, None]
        cos_sin = rope_cos_sin(pos2d, hd, cfg.rope_theta)
        barange = torch.arange(B, device=dev)
        p = attn.AttnParams(window=None, logit_cap=None, causal=True)
    for l in range(cfg.n_layers):
        x = _mamba_layer_decode(x, lm._layer(params, l), cfg, opts, cache, l)
        if _shared_after(cfg, l):
            g = l // cfg.attn_every
            hn = rms_norm(x, sp["attn_norm"], cfg.norm_eps)
            q, k, v = lm._qkv_mm(hn, sp, cfg, opts, pos2d, cos_sin)
            kc, vc = cache["k"][g], cache["v"][g]
            kc[barange, positions] = k[:, 0].to(kc.dtype)
            vc[barange, positions] = v[:, 0].to(vc.dtype)
            o = attn.decode_attention(q, kc, vc, positions, p)
            x = x + mm(o.reshape(B, 1, H * hd), sp["wo"], opts.use_kernels)
            x = _shared_mlp(x, sp, cfg, opts)
    return _final_logits(x[:, 0], params, cfg, opts), cache

"""Whisper-style encoder-decoder (the audio family): parameters, the
encoder, the training forward, prefill, the decode caches and the decode
step.

Encoder: bidirectional self-attention over stub frame embeddings (the
conv / mel frontend is a stub, as in the reference: a prefill batch carries
precomputed ``frames`` (B, Te, d)).  Decoder: causal self-attention,
cross-attention over the encoder output, an MLP; LayerNorm and tanh GELU,
RoPE on the self-attention's q and k (none on the cross-attention).

``enc_layers`` / ``dec_layers`` carry a leading (L,) axis, walked by
``lm._layer`` (a stacked tree or ``lm.unstack_layers``' per-layer list).
Every projection and the LM head go through ``lm.mm``: the ``qmatmul`` /
``qmatmul_lut`` kernel on coded weights on the card.  The decode cache is
the self K/V (Ld, B, rows, KV, hd) and the cross K/V (Ld, B, Te, KV, hd)
that prefill computes once from the encoder output; decode writes the self
rows in place and never changes the cross rows.

As in the reference: ``init_cache`` gives the self and the cross K/V
``max_len // 2`` rows each (the closed batch's ``generate`` never runs the
encoder, so its cross K/V stay zeros and the cross-attention adds 0); a
decode write at a position past the self rows is dropped (JAX drops an
out-of-bounds scatter), while every row stays visible to the query; and no
``a_bits`` fake-quant is applied.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       rope_cos_sin)
from repro_torch.models.lm import ModelOpts, mm


def _ln(x, p, cfg: ArchConfig):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _init_attn(weight, cfg: ArchConfig, stack: str, L: int,
               prefix: str = "") -> Dict[str, Any]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {f"{prefix}{name}": weight(f"{stack}/{prefix}{name}", shape,
                                      dense_init, True)
            for name, shape in (("wq", (L, d, H * hd)),
                                ("wk", (L, d, KV * hd)),
                                ("wv", (L, d, KV * hd)),
                                ("wo", (L, H * hd, d)))}


def _init_mlp(weight, cfg: ArchConfig, stack: str, L: int) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": weight(f"{stack}/w_up", (L, d, f), dense_init, True),
            "w_down": weight(f"{stack}/w_down", (L, f, d), dense_init, True)}


@torch.no_grad()
def init_params(seed: int, cfg: ArchConfig, device="cuda", w_bits: int = 16,
                dense_dtype=torch.float32,
                w_dist: str = "gaussian") -> Dict[str, Any]:
    """Random whisper parameter tree on ``device`` from ``seed`` (the
    reference's ``init_params_encdec``), drawn (and with ``w_bits`` 4 / 8
    coded) a layer slice at a time through ``lm.weight_drawer``.  The
    LayerNorm ``{"scale", "bias"}`` leaves stay f32.  At W4 the LM head
    (d, vocab) stays dense where the vocab is odd (int4 packing pairs
    columns), as the reference's coding skips it."""
    weight, _, dev = lm.weight_drawer(seed, device, w_bits, dense_dtype,
                                      w_dist=w_dist)
    Le, Ld, d = cfg.enc_layers, cfg.dec_layers, cfg.d_model

    def norm(*shape):
        return lm.norm_param(cfg, *shape, device=dev)

    enc = {"attn_norm": norm(Le, d), "mlp_norm": norm(Le, d),
           **_init_attn(weight, cfg, "enc_layers", Le),
           **_init_mlp(weight, cfg, "enc_layers", Le)}
    dec = {"attn_norm": norm(Ld, d), "cross_norm": norm(Ld, d),
           "mlp_norm": norm(Ld, d),
           **_init_attn(weight, cfg, "dec_layers", Ld),
           **_init_attn(weight, cfg, "dec_layers", Ld, prefix="cross_"),
           **_init_mlp(weight, cfg, "dec_layers", Ld)}
    return {"embed": weight("embed", (cfg.vocab, d), embed_init, False),
            "enc_layers": enc, "dec_layers": dec,
            "enc_final_norm": norm(d), "final_norm": norm(d),
            "lm_head": weight("lm_head", (d, cfg.vocab), dense_init, False)}


def _mlp_apply(x, lp, opts: ModelOpts):
    h = F.gelu(mm(x, lp["w_up"], opts.use_kernels), approximate="tanh")
    return mm(h, lp["w_down"], opts.use_kernels)


def _out(o, w, cfg: ArchConfig, opts: ModelOpts):
    B, S = o.shape[:2]
    return mm(o.reshape(B, S, cfg.n_heads * cfg.head_dim), w,
              opts.use_kernels)


def _self_attn(x, lp, cfg: ArchConfig, opts: ModelOpts, positions, cos_sin,
               causal: bool):
    """Self-attention over (B, S, d) (x already normed; chunked from S =
    ``opts.attn_chunked_min_len`` on); returns (out, (k, v))."""
    q, k, v = lm._qkv_mm(x, lp, cfg, opts, positions, cos_sin)
    p = attn.AttnParams(window=None, logit_cap=None, causal=causal)
    pos1d = positions[0]
    o = attn.attend(q, k, v, pos1d, pos1d, p, opts)
    return _out(o, lp["wo"], cfg, opts), (k, v)


def _cross_attn(x, ek, ev, lp, cfg: ArchConfig, opts: ModelOpts):
    """Queries from the decoder's (normed) x, every encoder row visible."""
    B, S, _ = x.shape
    q = mm(x, lp["cross_wq"], opts.use_kernels).reshape(
        B, S, cfg.n_heads, cfg.head_dim)
    p = attn.AttnParams(window=None, logit_cap=None, causal=False)
    qpos = torch.zeros((S,), dtype=torch.long, device=x.device)
    kpos = torch.zeros((ek.shape[1],), dtype=torch.long, device=x.device)
    o = attn.full_attention(q, ek, ev, qpos, kpos, p)
    return _out(o, lp["cross_wo"], cfg, opts)


def _enc_layer(x, lp, cfg: ArchConfig, opts: ModelOpts, positions, cos_sin):
    a, _ = _self_attn(_ln(x, lp["attn_norm"], cfg), lp, cfg, opts,
                      positions, cos_sin, causal=False)
    x = x + a
    return x + _mlp_apply(_ln(x, lp["mlp_norm"], cfg), lp, opts)


def encode(params, cfg: ArchConfig, opts: ModelOpts, frames):
    """frames (B, Te, d) stub embeddings -> encoder output (B, Te, d) in
    the compute dtype; differentiable (the serving callers run it under
    ``torch.no_grad``), each layer recomputed in the backward pass under
    ``opts.remat``."""
    x = frames.to(opts.compute_dtype)
    B, Te, _ = x.shape
    positions, cos_sin = lm.rope_positions(B, Te, cfg, x.device)
    for l in range(cfg.enc_layers):
        x = lm.apply_layer(_enc_layer, opts.remat, x,
                           lm._layer(params, l, "enc_layers"), cfg, opts,
                           positions, cos_sin)
    return _ln(x, params["enc_final_norm"], cfg)


def _dec_layer(x, lp, enc_out, cfg: ArchConfig, opts: ModelOpts, positions,
               cos_sin):
    """One decoder layer over (B, S, d): causal self-attention, the
    cross-attention over this layer's cross K/V of the encoder output, the
    MLP.  Returns (x, (k, v, cross k, cross v))."""
    B, Te = enc_out.shape[:2]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    a, (k, v) = _self_attn(_ln(x, lp["attn_norm"], cfg), lp, cfg, opts,
                           positions, cos_sin, causal=True)
    x = x + a
    ek = mm(enc_out, lp["cross_wk"], opts.use_kernels).reshape(B, Te, KV, hd)
    ev = mm(enc_out, lp["cross_wv"], opts.use_kernels).reshape(B, Te, KV, hd)
    x = x + _cross_attn(_ln(x, lp["cross_norm"], cfg), ek, ev, lp, cfg, opts)
    x = x + _mlp_apply(_ln(x, lp["mlp_norm"], cfg), lp, opts)
    return x, (k, v, ek, ev)


def forward_train(params, cfg: ArchConfig, opts: ModelOpts, batch):
    """Teacher-forced LM loss (the reference's ``forward_train_encdec``):
    encode ``batch["frames"]`` (B, Te, d), the decoder over
    ``batch["tokens"]`` with each layer's cross K/V of the encoder output,
    the final LayerNorm and the chunked cross-entropy on the LM head against
    ``batch["targets"]``.  No cache; with ``opts.remat`` every layer of
    both stacks is recomputed in the backward pass."""
    for key, n in (("enc_layers", cfg.enc_layers),
                   ("dec_layers", cfg.dec_layers)):
        if not isinstance(params[key], list):
            params = lm.unstack_layers(params, n, key)
    enc_out = encode(params, cfg, opts, batch["frames"])
    x = lm._embed_tokens(params, cfg, opts, batch["tokens"])
    B, S, _ = x.shape
    positions, cos_sin = lm.rope_positions(B, S, cfg, x.device)
    for l in range(cfg.dec_layers):
        x, _ = lm.apply_layer(_dec_layer, opts.remat, x,
                              lm._layer(params, l, "dec_layers"), enc_out,
                              cfg, opts, positions, cos_sin)
    x = _ln(x, params["final_norm"], cfg)
    return lm.chunked_ce_loss(x, params["lm_head"], batch["targets"], cfg,
                              opts)


@torch.no_grad()
def forward_prefill(params, cfg: ArchConfig, opts: ModelOpts, batch):
    """Encode ``batch["frames"]``, then the teacher-forced decoder over
    ``batch["tokens"]`` (B, S) (the reference's ``forward_prefill_encdec``).
    Returns (last-position logits (B, V) f32, {"k", "v"} (Ld, B, S, KV, hd)
    and {"cross_k", "cross_v"} (Ld, B, Te, KV, hd) in the compute dtype)."""
    enc_out = encode(params, cfg, opts, batch["frames"])
    x = lm._embed_tokens(params, cfg, opts, batch["tokens"])
    B, S, _ = x.shape
    positions, cos_sin = lm.rope_positions(B, S, cfg, x.device)
    caches = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for l in range(cfg.dec_layers):
        x, kvs = _dec_layer(x, lm._layer(params, l, "dec_layers"), enc_out,
                            cfg, opts, positions, cos_sin)
        for name, t in zip(("k", "v", "cross_k", "cross_v"), kvs):
            caches[name].append(t)
    x = _ln(x, params["final_norm"], cfg)
    logits = lm._logits(x[:, -1], params, cfg, opts)
    return logits, {name: torch.stack(ts) for name, ts in caches.items()}


@torch.no_grad()
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode cache: {"k", "v", "cross_k", "cross_v"}, each
    (Ld, batch, max_len // 2, KV, hd) in ``dtype``.  The self and the
    cross rows are both half of ``max_len``, as the reference's
    ``model.init_cache`` sizes them for the audio family (its encoder and
    decoder lengths split one sequence length)."""
    dev = resolve_device(device)
    shape = (cfg.dec_layers, batch, max_len // 2, cfg.n_kv_heads,
             cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name in ("k", "v", "cross_k", "cross_v")}


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """The cache's shapes and dtypes as ``device="meta"`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                positions):
    """One decoder step (the reference's ``decode_step_encdec``): tokens
    (B, 1), positions (B,).  Each layer writes the fresh self K/V row at
    each row's position, in place, then attends over the self rows under
    the causal mask and over the cached cross K/V (all visible).  A
    position at or past the self rows is not written (the reference's
    scatter drops it) and every self row stays visible: the write goes to
    the last row with that row's old value, so no host sync decides it.
    Returns (logits (B, V) f32, the cache)."""
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev)
    positions = torch.as_tensor(positions, device=dev).to(torch.long)
    x = lm._embed_tokens(params, cfg, opts, tokens)          # (B, 1, d)
    B = x.shape[0]
    rows = cache["k"].shape[2]
    keep = (positions < rows)[:, None, None]
    idx = torch.clamp(positions, max=rows - 1)
    barange = torch.arange(B, device=dev)
    pos2d = positions[:, None]
    cos_sin = rope_cos_sin(pos2d, cfg.head_dim, cfg.rope_theta)
    cross_pos = torch.full((B,), cache["cross_k"].shape[2] - 1,
                           dtype=torch.long, device=dev)
    p_self = attn.AttnParams(window=None, logit_cap=None, causal=True)
    p_cross = attn.AttnParams(window=None, logit_cap=None, causal=False)
    for l in range(cfg.dec_layers):
        lp = lm._layer(params, l, "dec_layers")
        q, k, v = lm._qkv_mm(_ln(x, lp["attn_norm"], cfg), lp, cfg, opts,
                             pos2d, cos_sin)
        kc, vc = cache["k"][l], cache["v"][l]
        for c, new in ((kc, k), (vc, v)):
            c[barange, idx] = torch.where(keep, new[:, 0].to(c.dtype),
                                          c[barange, idx])
        o = attn.decode_attention(q, kc, vc, positions, p_self)
        x = x + _out(o, lp["wo"], cfg, opts)
        qc = mm(_ln(x, lp["cross_norm"], cfg), lp["cross_wq"],
                opts.use_kernels).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        oc = attn.decode_attention(qc, cache["cross_k"][l],
                                   cache["cross_v"][l], cross_pos, p_cross)
        x = x + _out(oc, lp["cross_wo"], cfg, opts)
        x = x + _mlp_apply(_ln(x, lp["mlp_norm"], cfg), lp, opts)
    x = _ln(x, params["final_norm"], cfg)
    return lm._logits(x[:, 0], params, cfg, opts), cache

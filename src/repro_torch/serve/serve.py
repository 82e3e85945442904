"""Serving: prefill / decode steps over (optionally UNIQ-quantized) weights
and a simple batched generation loop.

Weights live as packed int4/int8 k-quantile codes (+ per-channel Gaussian
stats, or a per-tensor empirical codebook) and are dequantized on the fly
inside the matmul — a quarter of the weight bytes at W4, the dominant
memory term of batched decode.  Activations are optionally fake-quantized
to ``a_bits`` at each layer's output (paper Sec. 3.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, model
from repro_torch.models.lm import ModelOpts
from repro_torch.serve import sampling
from repro_torch.serve import telemetry as tele_lib


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    w_bits: int = 16               # 4 / 8 -> k-quantile coded weights
    a_bits: int = 32
    max_len: int = 2048
    temperature: float = 0.0       # 0 = greedy
    w_dist: str = "gaussian"       # analytic levels | "empirical" codebook


def prepare_params(params, sc: ServeConfig, device="cuda"):
    """Quantize trained weights for serving (no-op at w_bits >= 16)."""
    if sc.w_bits >= 16:
        return params
    return model.quantize_for_serving(params, sc.w_bits, dist=sc.w_dist,
                                      device=device)


def make_serve_opts(opts: ModelOpts, sc: ServeConfig) -> ModelOpts:
    return dataclasses.replace(opts, a_bits=sc.a_bits)


def make_decode_step(cfg: ArchConfig, opts: ModelOpts):
    def serve_step(params, cache, tokens, positions):
        return model.decode(params, cfg, opts, cache, tokens, positions)
    return serve_step


def make_prefill_step(cfg: ArchConfig, opts: ModelOpts):
    def prefill_step(params, batch):
        return model.prefill(params, cfg, opts, batch)
    return prefill_step


def _row_seeds(seed: int, batch: int):
    """One sampling seed per batch row, from ``seed``: rows draw unrelated
    streams."""
    return [sampling.draw_seed(seed, b) & 0x7FFFFFFF for b in range(batch)]


@torch.no_grad()
def sample(logits: torch.Tensor, temperature: float, seeds=None,
           positions=None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens on the logits' device.

    Greedy at temperature 0 (ties to the lowest index); else Gumbel-max
    over ``logits / temperature``, row b's noise a function of
    (``seeds[b]``, ``positions[b]``) only, as the engine draws it.  The
    draws are not comparable to ``jax.random.categorical``'s."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sampling.gumbel_max(logits.to(torch.float32) / temperature,
                               seeds, positions).to(torch.int32)


def _device_of(params) -> torch.device:
    leaf = params["final_norm"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


@torch.no_grad()
def generate(params, cfg: ArchConfig, opts: ModelOpts, sc: ServeConfig,
             prompt_tokens, n_new: int, seed: int = 0,
             telemetry: Optional["tele_lib.Telemetry"] = None,
             check_finite: bool = False):
    """Greedy / temperature generation: step the prompt, then decode.

    prompt_tokens (B, S0) int.  Returns (B, n_new) int32 generated ids on
    the params' device.  The cache is the family's ``model.init_cache`` for
    S0 + n_new rows (f32 for f32 compute, bf16 otherwise): the slot KV
    cache of the decoder-only families, the conv windows and SSM states
    (and zamba2's shared K/V) of ssm / hybrid, whisper's self and cross K/V
    of (S0 + n_new) // 2 rows each; the prompt is stepped token by token
    through ``model.decode``, as the reference does, so the run makes
    S0 + n_new - 1 decode steps.  As in the reference, whisper's encoder
    never runs here (its cross K/V stay zeros) and the vlm's steps see no
    patch embeddings.  Sampling at ``sc.temperature`` > 0 keys
    row b's draw at position t by (``_row_seeds(seed, B)[b]``, t).
    On a mesh (the dense and vlm decoders on placed parameters,
    ``opts.placement``) the prompt is whole on every rank, each rank decodes
    its rows of the batch (its block of the cache) and every rank emits the
    same tokens, from the whole logits.
    ``telemetry`` (serve/telemetry.py) records a "generate" span and the
    ``prompt_tokens`` / ``tokens_decoded`` counters; with it on, the span
    ends after a device sync, so it covers the compute.  ``check_finite``
    (a debug aid: a host sync a step) raises RuntimeError at the first step
    whose logits are not all finite.
    """
    model.require_ported(cfg, "generate")
    tel = telemetry if telemetry is not None else tele_lib.NULL_TELEMETRY
    dev = _device_of(params)
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    B, S0 = prompt.shape
    max_len = S0 + n_new
    dtype = torch.float32 if opts.compute_dtype == torch.float32 \
        else torch.bfloat16
    cache = model.init_cache(cfg, B, max_len, dtype, device=dev, opts=opts)
    # the stack the step walks, sliced into per-layer views once, not on
    # every step
    key, n = ("dec_layers", cfg.dec_layers) if cfg.family == "audio" \
        else ("layers", cfg.n_layers)
    if not isinstance(params[key], list):
        params = lm.unstack_layers(params, n, key)
    serve_step = make_decode_step(cfg, opts)
    seeds = _row_seeds(seed, B)
    tok = prompt[:, :1]
    out = []
    with tel.span("generate", batch=B, prompt_tokens=S0, n_new=n_new):
        for t in range(max_len - 1):
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            logits, cache = serve_step(params, cache, tok, pos)
            if check_finite and not bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"generate: non-finite logits at decode "
                                   f"step {t} (position {t})")
            if t + 1 < S0:
                tok = prompt[:, t + 1:t + 2]
            else:
                tok = sample(logits, sc.temperature, seeds, [t] * B)[:, None]
                out.append(tok[:, 0])
            if len(out) >= n_new:
                break
        result = torch.stack(out, dim=1)
        if tel.enabled and dev.type == "cuda":
            # sync so the span covers the compute, not the launches
            torch.cuda.synchronize(dev)
    tel.inc(tel.registry.counter("prompt_tokens"), B * S0)
    tel.inc(tel.registry.counter("tokens_decoded"), B * len(out))
    return result

"""Architecture configuration schema + registry, and the benchmark shapes.

Every served architecture is a module in this package registering an
``ArchConfig`` (public-literature dims) and a ``smoke()`` reduced variant
(same family, tiny dims) used by the CPU tests.  ``SHAPES`` are the
reference's (arch x shape) cells; ``input_specs`` gives a cell's model
inputs as allocation-free ``meta`` tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.25
    # gemma-2 style options
    sliding_window: Optional[int] = None   # width of local attention
    local_global_alternate: bool = False   # odd layers local, even global
    attn_logit_cap: Optional[float] = None
    final_logit_cap: Optional[float] = None
    mlp_act: str = "silu"
    post_norms: bool = False               # gemma-2 post-attn/post-mlp norms
    qkv_bias: bool = False
    embed_scale: bool = False              # multiply embeddings by sqrt(d)
    tie_embeddings: bool = False
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_dconv: int = 4
    attn_every: int = 0                    # hybrid: shared attn block period
    # enc-dec (audio)
    enc_layers: int = 0
    dec_layers: int = 0
    # vlm stub frontend
    n_patches: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    norm_kind: str = "rms"                 # rms | layer

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid families per assignment)."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# every architecture of the reference's registry
ARCH_IDS = [
    "pixtral_12b", "granite_3_8b", "stablelm_12b", "gemma2_9b", "yi_6b",
    "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b", "zamba2_2_7b",
    "mamba2_1_3b", "whisper_base",
]

_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass
class ArchEntry:
    config: ArchConfig
    smoke: ArchConfig
    source: str                   # provenance note


def register(config: ArchConfig, smoke: ArchConfig, source: str):
    _REGISTRY[config.name] = ArchEntry(config, smoke, source)
    return config


def get(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name].config


def get_smoke(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name].smoke


def entries() -> Dict[str, ArchEntry]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    for arch in ARCH_IDS:
        if arch not in _REGISTRY:
            importlib.import_module(f"repro_torch.configs.{arch}")


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) runs, and the reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention family: long_500k skipped per spec"
    return True, ""


def input_specs(cfg: ArchConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Model inputs of a benchmark cell as ``meta`` tensors (shape and
    dtype, no storage), with the reference's keys and shapes.

    train  : tokens + targets (teacher forcing)
    prefill: tokens (+ frontend embeddings)
    decode : one new token + positions (the KV / SSM cache is built
             separately by the serving layer).

    Tokens, targets and positions are int32 (as the reference's and as the
    port's data stream and engine make them; the models also take int64);
    ``patch_embeds`` / ``frames`` (the vlm / audio stub frontends) bf16.
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device="meta")

    def emb(*s):
        return torch.empty(s, dtype=torch.bfloat16, device="meta")

    decode = {"tokens": tok(B, 1), "positions": tok(B)}
    if cfg.family == "audio":
        # enc-dec: encoder frames (stub embeddings) + decoder tokens
        enc_len = dec_len = S // 2
        if shape.kind == "train":
            return {"frames": emb(B, enc_len, cfg.d_model),
                    "tokens": tok(B, dec_len), "targets": tok(B, dec_len)}
        if shape.kind == "prefill":
            return {"frames": emb(B, enc_len, cfg.d_model),
                    "tokens": tok(B, dec_len)}
        return decode
    if cfg.family == "vlm":
        P = cfg.n_patches
        if shape.kind == "train":
            return {"patch_embeds": emb(B, P, cfg.d_model),
                    "tokens": tok(B, S - P), "targets": tok(B, S - P)}
        if shape.kind == "prefill":
            return {"patch_embeds": emb(B, P, cfg.d_model),
                    "tokens": tok(B, S - P)}
        return decode
    if shape.kind == "train":
        return {"tokens": tok(B, S), "targets": tok(B, S)}
    if shape.kind == "prefill":
        return {"tokens": tok(B, S)}
    return decode

"""Architecture configuration schema + registry.

Every served architecture is a module in this package registering an
``ArchConfig`` (public-literature dims) and a ``smoke()`` reduced variant
(same family, tiny dims) used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional


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


# every architecture of the reference's registry; the families ssm,
# hybrid, audio and vlm are registered as data and not ported yet
# (``models/model.py:require_ported``)
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

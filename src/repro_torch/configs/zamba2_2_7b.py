"""zamba2-2.7b [hybrid] — Mamba-2 backbone + shared attention block.

[arXiv:2411.15242; hf]  54L d_model=2560, shared attention block: 32H
(kv=32, i.e. MHA, head_dim=80) with d_ff=10240 MLP, applied every 6 Mamba
layers with *shared weights* (9 applications).  ssm_state=64.

Deviation noted in DESIGN.md: real Zamba2 adds per-invocation LoRA deltas
to the shared block; omitted here (pure weight sharing).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="zamba2_2_7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64,
    attn_every=6, rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="zamba2_2_7b_smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=16,
    attn_every=2,
)

register(CONFIG, SMOKE, "arXiv:2411.15242")

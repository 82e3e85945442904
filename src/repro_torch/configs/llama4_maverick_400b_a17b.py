"""llama4-maverick-400b-a17b [moe] — top-1-routed MoE, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]  48L d_model=5120
40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048, MoE 128 experts top-1.

Deviation noted in DESIGN.md: real Maverick alternates dense/MoE layers
and adds a shared expert; the assignment specifies uniform MoE layers.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, capacity_factor=1.25,
    rope_theta=500000.0,
)

SMOKE = ArchConfig(
    name="llama4_maverick_400b_a17b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512,
    n_experts=4, top_k=1, capacity_factor=1.5,
)

register(CONFIG, SMOKE, "hf:meta-llama/Llama-4")

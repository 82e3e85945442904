"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table dims).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (per expert) vocab=163840, MoE 384 experts top-8.
head_dim = 7168/64 = 112.

Deviations noted in DESIGN.md Sec. 4: the real K2 uses MLA attention, a
dense first layer and a shared expert; the assignment specifies uniform
GQA MoE layers, which we follow.  Router weights stay fp32 and are never
quantized (routing stability).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="kimi_k2_1t_a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, capacity_factor=1.25,
    rope_theta=50000.0,
)

SMOKE = ArchConfig(
    name="kimi_k2_1t_a32b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512,
    n_experts=8, top_k=2, capacity_factor=1.25,
)

register(CONFIG, SMOKE, "arXiv:2501.kimi2 (paper-table)")

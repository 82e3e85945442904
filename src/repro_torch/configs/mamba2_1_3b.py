"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L d_model=2048, d_ff=0 (no MLP — the
Mamba block is the whole layer), vocab=50280, ssm_state=128;
expand=2 -> d_inner=4096, headdim=64 -> 64 SSD heads.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="mamba2_1_3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
)

SMOKE = ArchConfig(
    name="mamba2_1_3b_smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=16,
)

register(CONFIG, SMOKE, "arXiv:2405.21060")

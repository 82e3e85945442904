"""yi-6b [dense] — llama-architecture GQA decoder.

[arXiv:2403.04652; hf]  32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000; rope theta 5e6 (Yi long-context convention).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5000000.0,
)

SMOKE = ArchConfig(
    name="yi_6b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, rope_theta=5000000.0,
)

register(CONFIG, SMOKE, "arXiv:2403.04652")

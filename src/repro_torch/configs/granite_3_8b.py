"""granite-3-8b [dense] — IBM Granite 3.0, GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base family; hf]  40L d_model=4096 32H
(GQA kv=8) d_ff=12800 vocab=49155.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="granite_3_8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155, rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="granite_3_8b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=512,
)

register(CONFIG, SMOKE, "hf:ibm-granite/granite-3.0")

"""stablelm-12b [dense] — Stability AI StableLM-2 12B, GQA decoder.

[hf:stabilityai/stablelm-2-1_6b family; hf]  40L d_model=5120 32H
(GQA kv=8) d_ff=13824 vocab=100352; head_dim = 5120/32 = 160.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="stablelm_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352, qkv_bias=False, rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="stablelm_12b_smoke", family="dense",
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, head_dim=20,
    d_ff=192, vocab=512,
)

register(CONFIG, SMOKE, "hf:stabilityai/stablelm-2-12b")

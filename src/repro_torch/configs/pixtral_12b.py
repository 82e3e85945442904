"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128 (Nemo convention).  The vision
frontend is a STUB per the assignment: ``input_specs`` provides precomputed
patch embeddings (n_patches x d_model).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="pixtral_12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, n_patches=256, rope_theta=1000000.0,
)

SMOKE = ArchConfig(
    name="pixtral_12b_smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_patches=8, rope_theta=1000000.0,
)

register(CONFIG, SMOKE, "hf:mistralai/Pixtral-12B-2409")

"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; head_dim=256; sliding window 4096 on local (odd) layers;
attention-logit cap 50, final-logit cap 30; GeGLU; pre+post norms;
embeddings scaled by sqrt(d) and tied with the LM head.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    sliding_window=4096, local_global_alternate=True,
    attn_logit_cap=50.0, final_logit_cap=30.0,
    mlp_act="gelu", post_norms=True, embed_scale=True, tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="gemma2_9b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    sliding_window=32, local_global_alternate=True,
    attn_logit_cap=50.0, final_logit_cap=30.0,
    mlp_act="gelu", post_norms=True, embed_scale=True, tie_embeddings=True,
)

register(CONFIG, SMOKE, "arXiv:2408.00118")

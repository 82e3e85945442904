"""whisper-base [audio] — encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356; unverified]  6L (6 enc + 6 dec) d_model=512 8H (MHA,
kv=8) d_ff=2048 vocab=51865; LayerNorm + GELU (whisper conventions);
absolute positions via the stub embeddings (encoder) / learned decoder
embedding replaced by RoPE for uniformity — noted in DESIGN.md.

The conv1d/mel frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, T_enc, d_model).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="whisper_base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    enc_layers=6, dec_layers=6,
    mlp_act="gelu", norm_kind="layer",
)

SMOKE = ArchConfig(
    name="whisper_base_smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    enc_layers=2, dec_layers=2,
    mlp_act="gelu", norm_kind="layer",
)

register(CONFIG, SMOKE, "arXiv:2212.04356")

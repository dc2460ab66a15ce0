"""Gemma2-9B — local+global alternating attention, logit softcaps,
post-sublayer norms [arXiv:2408.00118]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("attn_local", "attn_global"),
    ffn_activation="gelu",
    use_post_norm=True,
    embed_scale=True,
    final_logit_softcap=30.0,
    attn_logit_softcap=50.0,
    local_window=4096,
    rope_theta=10000.0,
    tie_embeddings=True,
)

"""Gemma-7B — dense, GeGLU, head_dim=256, MHA (kv=16) [arXiv:2403.08295]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern=("attn_global",),
    ffn_activation="gelu",
    embed_scale=True,
    rope_theta=10000.0,
    tie_embeddings=True,
)

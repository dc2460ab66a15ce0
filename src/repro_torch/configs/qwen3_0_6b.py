"""Qwen3-0.6B — dense, qk-norm, GQA kv=8 [hf:Qwen/Qwen3-0.6B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    layer_pattern=("attn_global",),
    ffn_activation="silu",
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

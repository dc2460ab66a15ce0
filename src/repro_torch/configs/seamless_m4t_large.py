"""SeamlessM4T-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].
24 encoder + 24 decoder layers; the speech frontend is a stub
(frontend="frames": precomputed conformer-frame embeddings)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    layer_pattern=("attn_global",),
    ffn_activation="silu",
    encoder_layers=24,
    rope_theta=10000.0,
    frontend="frames",
    tie_embeddings=True,
)

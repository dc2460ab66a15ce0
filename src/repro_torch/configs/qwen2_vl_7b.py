"""Qwen2-VL-7B — M-RoPE, dynamic-resolution ViT frontend (stubbed)
[arXiv:2409.12191].  The transformer backbone; the vision stream arrives
as precomputed patch embeddings (frontend="patches"), which the caller
passes to ``Model.forward(..., embeds=)`` with their (3, B, S) t/h/w
position ids."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    layer_pattern=("attn_global",),
    ffn_activation="silu",
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="patches",
    tie_embeddings=False,
)

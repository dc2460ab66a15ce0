"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 2:1
[arXiv:2402.19427].  MQA (kv=1), head_dim=256, window 2048."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "attn_local"),
    ffn_activation="gelu",
    embed_scale=True,
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
)

"""Mamba2-130M — SSD (state-space duality), attention-free
[arXiv:2405.21060].  d_inner = 2*d_model, 24 heads of dim 64, state 128."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,  # no separate FFN: the SSD mixer is the whole block
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_heads=24,
    ssm_head_dim=64,
    ssm_chunk=256,
    d_inner=1536,
    conv_width=4,
    tie_embeddings=True,
)

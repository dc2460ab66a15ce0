"""Kimi-K2 — trillion-parameter MoE, 384 experts top-8 (paper-table entry)
[arXiv:2501.kimi2; unverified].  Per the assignment: 61L, d_model=7168,
64 heads (GQA kv=8), per-expert d_ff=2048, vocab=163840.

Total parameters ~= 61 * 384 * 3 * 2048 * 7168 ≈ 1.03e12 (the "1T");
active ≈ 61 * (8 experts * 3 * 2048 * 7168 + attention) ≈ 30e9 ("a32b").
This is the FSDP stress config: it only fits with parameters sharded
over many devices.  The port serves and trains it at ``.reduced()`` on one
device; at its published widths it is sized, not run, by the dry-run
(``python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b``): on the
16 x 16 pod the experts split 256 ways (TP over E, FSDP over d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all-MoE FFNs
    vocab_size=163840,
    layer_pattern=("attn_global",),
    ffn_activation="silu",
    num_experts=384,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    capacity_factor=1.0,  # dispatch buffers at 1T scale must stay tight
    rope_theta=50000.0,
    tie_embeddings=False,
)

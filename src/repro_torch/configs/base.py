"""Model / training configuration schema.

Every assigned architecture is a ``ModelConfig`` instance in its own file
under ``repro_torch/configs``; reduced smoke variants derive from the full ones
via ``reduced()``.  The paper's technique enters through ``ApproxConfig``:
any dense projection can route its GEMM through the segmented-carry-chain
approximate multiplier (see repro_torch.engine for the mode registry and
backend dispatch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "ApproxConfig", "LayerQuality", "ModelConfig", "ShapeConfig",
    "TrainConfig", "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class LayerQuality:
    """One GEMM class's resolved accuracy selection.

    Produced by the ``repro_torch.engine.config`` controller (quality tiers ->
    per-target (n, t) via the closed-form error models) and carried in
    ``ApproxConfig.overrides``; ``None`` mode/backend inherit the base
    ``ApproxConfig`` values.
    """

    target: str  # "mlp" | "attn" | "moe"
    n: int
    t: int
    mode: Optional[str] = None
    backend: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Approximate-multiplier deployment for a model's GEMMs."""

    enabled: bool = False
    # (n, t) defaults are the ``balanced`` quality tier's mlp resolution
    # at the engine default bit-width (engine.config.default_t(8) == 4 —
    # pinned by tests); per-target selections ride in ``overrides``.
    n: int = 8  # operand magnitude bit-width
    t: int = 4  # carry-chain splitting point
    fix_to_1: bool = True
    # any name registered in repro_torch.engine.modes ('exact' | 'bitexact' |
    # 'lowrank' | 'inject' | 'fakequant' built in): fakequant/inject scale
    # to 1000-node training (O(1) overhead); lowrank/bitexact are the
    # faithful inference paths.
    mode: str = "inject"
    rank: int = 8
    # which projections are approximated ('mlp', 'attn', 'moe')
    targets: tuple = ("mlp",)
    # engine backend for the targeted GEMMs ('auto' | 'reference' | 'cuda')
    backend: str = "auto"
    # per-target LayerQuality entries (engine.config.apply_quality);
    # call sites resolve them with for_target
    overrides: tuple = ()

    def for_target(self, target: str) -> "ApproxConfig":
        """The effective config for one GEMM class: the matching
        ``LayerQuality`` override folded in, or ``self`` unchanged."""
        for q in self.overrides:
            if q.target == target:
                return dataclasses.replace(
                    self,
                    n=q.n,
                    t=q.t,
                    mode=self.mode if q.mode is None else q.mode,
                    backend=self.backend if q.backend is None else q.backend,
                    overrides=(),
                )
        return self


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block pattern, cycled over layers: entries in
    # {"attn_global", "attn_local", "rglru", "ssd"}
    layer_pattern: tuple = ("attn_global",)
    ffn_activation: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    use_qk_norm: bool = False
    use_post_norm: bool = False  # gemma2-style post-sublayer RMSNorm
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    final_logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    local_window: int = 4096
    rope_theta: float = 10000.0
    use_mrope: bool = False  # Qwen2-VL multimodal RoPE (3 sections)
    mrope_sections: tuple = (16, 24, 24)  # t/h/w halves of head_dim/2
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # RG-LRU / SSD
    lru_width: int = 0
    conv_width: int = 4
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    d_inner: int = 0
    # encoder-decoder (audio family)
    encoder_layers: int = 0
    # frontend stub for vlm/audio: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None  # "patches" | "frames"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # substrate knobs
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True
    # "xla": direct / blockwise online-softmax attention in plain torch
    #        (the JAX package's name for its plain path, kept so configs
    #        compare like with like); "pallas": the flash-attention
    #        kernels, which the port does not have yet (models/attention.py
    #        raises and names the slice that ports them).
    attn_impl: str = "xla"
    # Megatron-style sequence parallelism on the inter-block residual
    # stream: the remat-saved (B, S, D) activations are sharded over the
    # model axis (AG/RS at the TP-region boundaries are inferred by SPMD).
    # Required to fit kimi-k2's 1M-token train step (§Perf iteration 6).
    seq_shard_residuals: bool = False
    approx: ApproxConfig = ApproxConfig()

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally (long_500k eligibility)."""
        return all(k in ("rglru", "ssd", "attn_local") for k in self.layer_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test configuration of the same family."""
        small = dict(
            num_layers=max(2, len(self.layer_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            local_window=8,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(2, self.num_experts_per_tok) if self.num_experts else 0,
            moe_d_ff=32 if self.num_experts else 0,
            lru_width=64 if self.lru_width else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_heads=8 if self.ssm_heads else 0,  # must equal d_inner/head_dim
            ssm_head_dim=16 if self.ssm_heads else 64,
            ssm_chunk=8,
            d_inner=128 if self.d_inner else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            mrope_sections=(2, 3, 3),
            name=self.name + "-smoke",
            dtype="float32",
            remat="none",
        )
        small.update(over)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    grad_accum: int = 1
    opt_state_bits: int = 32  # 32 | 8 (quantized Adam moments)
    grad_compress_bits: int = 0  # 0 = off, 8 = int8 error-feedback compression
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3

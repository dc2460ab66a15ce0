"""Config registry: ``get_config("qwen3-0.6b")``, plus approx overrides.

Only the architectures whose blocks the port runs are registered: the
dense attention decoders qwen3-0.6b, gemma-7b (head width 256, one query
head per KV head), gemma2-9b (local and global layers in turn, both logit
softcaps, post-norms) and yi-9b (eight query heads per KV head, an untied
head); qwen2-vl-7b (M-RoPE over (3, B, S) t/h/w positions, patch
embeddings in place of tokens, seven query heads per KV head); the MoE
models granite-moe-1b-a400m and kimi-k2-1t-a32b (the latter at
``.reduced()`` only: its published widths need sharding); the
sub-quadratic models mamba2-130m (SSD blocks only) and recurrentgemma-2b
(RG-LRU blocks and local MQA attention, 2:1); the encoder-decoder
seamless-m4t-large-v2 (a non-causal encoder over frame embeddings, a
decoder with cross-attention over its memory); and the paper-multiplier
model.  kimi-k2-1t-a32b's published widths run through the dry-run
(``launch/dryrun.py``): one card cannot hold them.
``apply_approx(cfg, ...)`` deploys the paper's technique onto a config;
``list_archs`` and ``shapes_for`` name the (arch x shape) cells the
dry-run sizes."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.configs.base import SHAPES, ApproxConfig, ModelConfig, ShapeConfig

__all__ = [
    "ARCHS", "get_config", "list_archs", "apply_approx", "apply_quality", "shapes_for",
    "SHAPES",
]

# arch-id -> module name under repro_torch.configs
ARCHS = {
    "yi-9b": "yi_9b",
    "gemma-7b": "gemma_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "gemma2-9b": "gemma2_9b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-large-v2": "seamless_m4t_large",
    "paper-multiplier": "paper_multiplier",
}


def list_archs(include_paper: bool = False) -> list[str]:
    out = [a for a in ARCHS if a != "paper-multiplier"]
    if include_paper:
        out.append("paper-multiplier")
    return out


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def apply_approx(
    cfg: ModelConfig,
    *,
    n: int = 8,
    t: Optional[int] = None,
    mode: str = "inject",
    fix_to_1: bool = True,
    rank: int = 8,
    targets: tuple = ("mlp",),
    backend: str = "auto",
) -> ModelConfig:
    """Deploy the segmented-carry-chain approximate multiplier on ``cfg``.

    ``mode`` is validated against the engine's mode registry so a typo
    fails here (listing the valid names) rather than at trace time.  A
    ``t`` left ``None`` is resolved by the accuracy-configuration
    controller (``engine.config.default_t(n)`` — the balanced tier's
    cheapest valid split) instead of a hardcoded constant; for named
    tiers with per-GEMM-class selection use :func:`apply_quality`.
    """
    from repro_torch.engine import config as engine_config  # lazy: configs stay leaf-light
    from repro_torch.engine import modes as engine_modes

    engine_modes.get_mode(mode)
    if t is None:
        t = engine_config.default_t(n)
    return dataclasses.replace(
        cfg,
        approx=ApproxConfig(
            enabled=True, n=n, t=t, fix_to_1=fix_to_1, mode=mode, rank=rank,
            targets=targets, backend=backend,
        ),
    )


def apply_quality(cfg: ModelConfig, tier, *, n: int = 8, order: int = 1) -> ModelConfig:
    """Deploy a named quality tier (``repro_torch.engine.config``) onto ``cfg``:
    the controller resolves each budgeted GEMM class to its cheapest
    valid splitting point and installs the per-target overrides."""
    from repro_torch.engine import config as engine_config  # lazy import as above

    return engine_config.apply_quality(cfg, tier, n=n, order=order)


def shapes_for(cfg: ModelConfig) -> dict[str, ShapeConfig]:
    """The assigned shape cells that apply to this architecture.

    ``long_500k`` needs sub-quadratic attention -> only SSM/hybrid families.
    All archs have autoregressive decoders, so no decode-shape skips.
    """
    out = dict(SHAPES)
    if not cfg.sub_quadratic:
        out.pop("long_500k")
    return out

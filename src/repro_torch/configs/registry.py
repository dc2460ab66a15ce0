"""Config registry: ``get_config("qwen3-0.6b")``, plus approx overrides.

Only the architectures whose blocks the port runs are registered; the
other configurations of ``repro/configs`` come over with the slice that
ports their block kinds (ROADMAP.md, "Modules to port" item 10).
``apply_approx(cfg, ...)`` deploys the paper's technique onto a config."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.configs.base import ApproxConfig, ModelConfig

__all__ = ["ARCHS", "get_config", "apply_approx", "apply_quality"]

# arch-id -> module name under repro_torch.configs
ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
}


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

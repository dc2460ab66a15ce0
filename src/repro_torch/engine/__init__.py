"""Backend-dispatching engine for the approximate-multiply stack.

Counterpart of ``repro/engine``: the mode registry (``modes``), the
``reference | cuda | auto`` backend policy (``policy``), the product-table
cache (``artifacts``), the split-word recurrence (``recurrence``) and the
accuracy-configuration controller (``config``)::

    from repro_torch import engine
    y = engine.matmul(x, w, n=8, t=4, mode="bitexact")   # (M,K)@(K,N) f32
    p = engine.multiply(a, b, n=8, t=4)                  # elementwise, uint32

Submodules load lazily so that leaf modules (``recurrence``, ``policy``)
import without cycles.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "matmul": "dispatch",
    "multiply": "dispatch",
    "BACKENDS": "dispatch",
    "resolve_backend": "dispatch",
    "list_modes": "modes",
    "get_mode": "modes",
    "register_mode": "modes",
    "ModeSpec": "modes",
    "GemmParams": "modes",
    "quantize_operands": "modes",
    "bitexact_gemm_int": "modes",
    "seqmul_gemm_int": "modes",
    "resolve_t": "config",
    "kernel_tiles": "config",
    "resolve_tier": "config",
    "apply_quality": "config",
    "list_tiers": "config",
    "get_tier": "config",
    "ErrorBudget": "config",
    "QualityTier": "config",
    "QualityError": "config",
}
_SUBMODULES = ("artifacts", "config", "dispatch", "modes", "policy", "recurrence")

__all__ = sorted(_LAZY) + list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.engine.{name}")
    if name in _LAZY:
        return getattr(importlib.import_module(f"repro_torch.engine.{_LAZY[name]}"), name)
    raise AttributeError(f"module 'repro_torch.engine' has no attribute {name!r}")

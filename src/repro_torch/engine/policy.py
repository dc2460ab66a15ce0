"""Backend-selection policy for the port's engine.

Counterpart of ``repro/engine/policy.py``.  The backends are:

``reference``  the plain PyTorch bodies (any device; the CPU's only path).
``cuda``       the hand-written Hopper kernels (``repro_torch.kernels``).
``auto``       ``cuda`` for a CUDA tensor on an sm_90 device, ``reference``
               for a CPU tensor.

There is no silent fallback: an explicit ``cuda`` with a CPU tensor
raises, and so does a CUDA tensor on a device that is not sm_90 (the
kernels are built for ``sm_90a`` only).
"""

from __future__ import annotations

import torch

__all__ = ["BACKENDS", "require_sm90", "resolve_backend"]

BACKENDS = ("auto", "reference", "cuda")


def require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device of compute capability 9.0."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got one on {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (Hopper); {device} has "
            f"compute capability {cap[0]}.{cap[1]}"
        )


def resolve_backend(backend: str, device: torch.device) -> str:
    """Map ``auto`` to a concrete backend for tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid backends: {list(BACKENDS)}")
    if backend == "reference":
        return backend
    if device.type == "cpu":
        if backend == "cuda":
            raise ValueError("backend='cuda' was requested for a CPU tensor")
        return "reference"
    require_sm90(device)
    return "cuda"

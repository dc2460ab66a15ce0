"""Device selection for the port's entry points.

The port targets one NVIDIA H100.  An entry point runs on ``cuda`` unless
its caller asks for the CPU explicitly (as the tests do); without a GPU
and without that request it raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only on request; raise if CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu' (or 'meta' "
                         f"for shapes only)")
    return dev

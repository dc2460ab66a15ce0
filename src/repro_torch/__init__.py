"""PyTorch / CUDA port of the accuracy-configurable sequential multiplier.

A second package beside the JAX reference (``repro``): the paper's
split-word recurrence, its product tables and error models, the engine's
GEMM modes, the decoder stack and the continuous-batching server, with
every Pallas kernel on the serve path replaced by a CUDA C++ kernel for
Hopper (``repro_torch.kernels``).  The layout mirrors ``repro`` module for
module; the package imports ``torch`` and numpy, never ``jax`` and nothing
of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise
(:func:`repro_torch.device.resolve_device`).
"""

"""Hand-written Hopper (sm_90a) kernels of the port, CUDA C++ under ``csrc/``.

Each module holds one kernel's wrapper (device, dtype, shape and
contiguity checks; launch on the current stream; launch count) and its
plain PyTorch version, which the wrapper takes only for CPU tensors.

==================  ==============================================  ==========
kernel              replaces (JAX package)                          mode
==================  ==============================================  ==========
``lut_matmul``      ``repro/kernels/lut_matmul.py`` ``_kernel``      bitexact
``seqmul_matmul``   ``repro/kernels/seqmul_matmul.py`` ``_kernel``   seqmul
``packed_matmul``   ``repro/kernels/packed_matmul.py`` ``_kernel``   inject
==================  ==============================================  ==========
"""

from repro_torch.kernels import lut_matmul, packed_matmul, seqmul_matmul

__all__ = ["ALL", "launch_counts", "reset_launch_counts"]

ALL = {
    "lut_matmul": lut_matmul.KERNEL,
    "seqmul_matmul": seqmul_matmul.KERNEL,
    "packed_matmul": packed_matmul.KERNEL,
}


def launch_counts() -> dict:
    """Launches of every kernel since the last reset."""
    return {name: k.launches for name, k in ALL.items()}


def reset_launch_counts() -> None:
    for k in ALL.values():
        k.launches = 0

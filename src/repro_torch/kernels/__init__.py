"""Hand-written Hopper (sm_90a) kernels of the port, CUDA C++ under ``csrc/``.

Each module holds one kernel's wrapper (device, dtype, shape and
contiguity checks; launch on the current stream; launch count) and its
plain PyTorch version, which the wrapper takes only for CPU tensors.

=============================  ====================================================  ==================
kernel                         replaces (JAX package)                                path
=============================  ====================================================  ==================
``lut_matmul``                 ``repro/kernels/lut_matmul.py`` ``_kernel``           GEMM, bitexact
``seqmul_matmul``              ``repro/kernels/seqmul_matmul.py`` ``_kernel``        GEMM, seqmul
``packed_matmul``              ``repro/kernels/packed_matmul.py`` ``_kernel``        GEMM, inject
``lowrank_matmul``             ``repro/kernels/lowrank_matmul.py`` ``_kernel``       GEMM, lowrank
``flash_attention``            ``repro/kernels/flash_attention.py`` ``_fwd_kernel``  prefill, exact
``flash_attention_bwd_dq``     ``repro/kernels/flash_attention.py`` ``_dq_kernel``   training backward
``flash_attention_bwd_dkv``    ``repro/kernels/flash_attention.py`` ``_dkv_kernel``  training backward
``flash_decode``               ``repro/kernels/flash_attention.py``                  every decode step
                               ``_decode_kernel``
``approx_attention_bitexact``  ``repro/kernels/approx_attention.py``                 prefill, bitexact
                               ``_bitexact_kernel``
``approx_attention_lowrank``   ``repro/kernels/approx_attention.py``                 prefill, lowrank
                               ``_lowrank_kernel``
``seqmul_packed``              ``repro/kernels/seqmul_kernel.py`` ``_kernel``        ``engine.multiply``
``seqmul_words``               ``repro/kernels/seqmul_kernel.py`` ``_words_kernel``  error analysis,
                                                                                     n <= 16
=============================  ====================================================  ==================

The attention kernels run under ``attn_impl="pallas"`` (``models/attention.py``);
the backward pair runs for both the exact and the approximate forward.  The
elementwise pair (``seqmul_kernel``) serves ``engine.multiply`` and
``kernels.ops.approx_multiply`` (``seqmul_packed``) and the simulated error
analysis of ``core.error_metrics`` up to n = 16 (``seqmul_words``).
"""

from repro_torch.kernels import (
    approx_attention, flash_attention, lowrank_matmul, lut_matmul, packed_matmul, seqmul_kernel,
    seqmul_matmul,
)

__all__ = ["ALL", "launch_counts", "reset_launch_counts"]

ALL = {
    "lut_matmul": lut_matmul.KERNEL,
    "seqmul_matmul": seqmul_matmul.KERNEL,
    "packed_matmul": packed_matmul.KERNEL,
    "lowrank_matmul": lowrank_matmul.KERNEL,
    "flash_attention": flash_attention.FORWARD_KERNEL,
    "flash_attention_bwd_dq": flash_attention.DQ_KERNEL,
    "flash_attention_bwd_dkv": flash_attention.DKV_KERNEL,
    "flash_decode": flash_attention.DECODE_KERNEL,
    "approx_attention_bitexact": approx_attention.BITEXACT_KERNEL,
    "approx_attention_lowrank": approx_attention.LOWRANK_KERNEL,
    "seqmul_packed": seqmul_kernel.PACKED_KERNEL,
    "seqmul_words": seqmul_kernel.WORDS_KERNEL,
}


def launch_counts() -> dict:
    """Launches of every kernel since the last reset."""
    return {name: k.launches for name, k in ALL.items()}


def reset_launch_counts() -> None:
    for k in ALL.values():
        k.launches = 0

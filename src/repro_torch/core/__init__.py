"""Core contribution of the paper: the accuracy-configurable sequential
multiplier via segmented carry chains, its error metrics and models, and
the approximate-GEMM shims that carry it into the framework.

Counterpart of ``repro/core/__init__.py``, with the same exports.
"""

from repro_torch.core.approx_matmul import Mode, approx_matmul, approx_matmul_int, error_moments
from repro_torch.core.error_metrics import ErrorReport, eval_pairs, exhaustive_eval, mc_eval
from repro_torch.core.error_model import estimate, mae_closed_form, max_ed_dropped_carry
from repro_torch.core.luts import error_lut, lut_stats, product_lut, svd_error_factors
from repro_torch.core.quantization import (
    QuantParams, calibrate_absmax, dequantize, fake_quant, quantize,
)
from repro_torch.core.seqmul import (
    MAX_N,
    ProductWords,
    assemble_product_u64,
    seq_mul_approx_u32,
    seq_mul_exact_u32,
    seq_mul_words,
)

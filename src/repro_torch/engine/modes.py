"""Mode registry for the approximate-GEMM engine.

Counterpart of ``repro/engine/modes.py``.  Every execution mode is a
registered :class:`ModeSpec` carrying its reference body (plain PyTorch,
any device) and, where one exists, its CUDA body (the hand-written Hopper
kernel in ``repro_torch.kernels``).  ``repro_torch.engine.matmul`` looks
the mode up here and dispatches.

Registered modes
----------------
``exact``      plain f32 matmul (the baseline).
``bitexact``   every scalar product from the (2^n, 2^n) product table
               (n <= 8); CUDA body: ``kernels.lut_matmul``.
``seqmul``     the split-word recurrence per product (n <= 12); CUDA
               body: ``kernels.seqmul_matmul``.
``inject``     quantized exact GEMM + moment-matched Gaussian error;
               CUDA body: ``kernels.packed_matmul`` (two int16 lanes per
               word), noise added outside the kernel.
``lowrank``    exact quantized GEMM + the rank-r SVD correction of the
               error table (n <= 8); CUDA body: ``kernels.lowrank_matmul``.
``fakequant``  straight-through fake quantization of both operands.

Tensor parallelism.  A GEMM of a placed layer carries its shard
(``GemmParams.shard``, a ``sharding.Shard``: the role and the model axis),
and three couplings make the sharded GEMM the unsharded one's:

- **absmax.**  The weight's is taken over every model rank its shards are
  split over; a row-parallel activation is split along K, so its absmax is
  global over the model group too (beside the data group of its rows).
- **integer partial sums.**  A row-parallel shard of ``bitexact``,
  ``seqmul`` or ``inject`` takes its kernel's integer epilogue (the exact
  sums of its K slice) and the model group adds those integers, in int64,
  before the one conversion and ``* scale``.  Float32 partials would round
  in the shard count's own way wherever |sum| >= 2^24 (qwen3's ``w2``: K =
  3,072 at n = 8 reaches it).  ``lowrank``, ``exact`` and ``fakequant``
  add float32 partials (``lowrank`` holds at its rtol of 2e-6).
- **``inject``'s noise** is drawn over the global (M, N), rows over the
  data group as before; a column shard keeps its own columns, a row shard
  adds the (M, N) noise once, after the reduce, with the moments of the
  whole K.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import quantization
from repro_torch.distributed import sharding
from repro_torch.engine import artifacts
from repro_torch.kernels.lowrank_matmul import lowrank_matmul, lowrank_matmul_plain
from repro_torch.kernels.lut_matmul import lut_matmul, lut_matmul_plain
from repro_torch.kernels.packed_matmul import pack_i16_pairs, packed_matmul
from repro_torch.kernels.seqmul_matmul import seqmul_matmul, seqmul_matmul_plain

__all__ = [
    "GemmParams",
    "ModeSpec",
    "register_mode",
    "get_mode",
    "list_modes",
    "default_generator",
    "quantize_operands",
    "bitexact_gemm_int",
    "seqmul_gemm_int",
    "substitute_kernels",
]

class GemmParams(NamedTuple):
    """Static configuration threaded to every mode body; ``shard`` is the
    GEMM's tensor-parallel role (``sharding.Shard``) or None."""

    n: int
    t: int
    fix_to_1: bool
    rank: int
    shard: Optional[sharding.Shard] = None


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One registered execution mode.

    ``reference``/``cuda`` have signature ``(x, w, p, *extra) -> out`` on
    f32 2-D operands; ``extra`` is what ``prepare`` returned (f32 tensors
    that receive no gradient).  ``cuda=None`` means the reference body
    runs on every backend.  ``differentiable=False`` makes the engine wrap
    the forward in a straight-through ``autograd.Function`` whose backward
    is the exact matmul gradient.
    """

    name: str
    reference: Callable
    cuda: Optional[Callable] = None
    prepare: Optional[Callable] = None  # (x, w, p, generator) -> tuple of f32 tensors
    needs_key: bool = False
    differentiable: bool = True
    description: str = ""


_REGISTRY: dict[str, ModeSpec] = {}


def register_mode(spec: ModeSpec) -> ModeSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"mode {spec.name!r} is already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_mode(name: str) -> ModeSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown mode {name!r}; registered modes: {list_modes()}") from None


def list_modes() -> list[str]:
    return sorted(_REGISTRY)


def default_generator(mode: str, generator, device: torch.device):
    """The generator a model layer hands to ``matmul`` for ``mode``.

    Mirrors ``repro.engine.modes.resolve_key``: a stochastic mode called
    without a generator draws from a fixed seed-0 generator, so
    evaluation is deterministic (``matmul`` itself stays strict).
    """
    if get_mode(mode).needs_key and generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator


# ------------------------------------------------------------------ helpers
def _x_reduce(shard):
    """The activation's absmax reduction: over the ranks its rows are split
    over (``sharding.global_max``), and over the model group where a row
    shard splits it along K."""
    if shard is None or shard.role != "row":
        return sharding.global_max
    return lambda t: sharding.all_reduce_max(sharding.global_max(t), shard.axis)


def _w_reduce(shard):
    """The weight's absmax reduction: over the model ranks it is split over."""
    if shard is None:
        return None
    return lambda t: sharding.all_reduce_max(t, shard.axis)


def quantize_operands(x: torch.Tensor, w: torch.Tensor, n: int, shard=None):
    """Sign-magnitude absmax quantization of both GEMM operands.

    Returns ``((mag_x, sign_x), (mag_w, sign_w), scale)``; calibration
    sees detached tensors (scales are data, not parameters).  The
    activation's absmax is global over the ranks its rows are split over
    (``sharding.global_max``) and, for a row ``shard``, over the model
    group; a sharded weight's is global over the model group.
    """
    qx = quantization.calibrate_absmax(x.detach(), bits=n, reduce=_x_reduce(shard))
    qw = quantization.calibrate_absmax(w.detach(), bits=n, reduce=_w_reduce(shard))
    mx, sx = quantization.quantize(x, qx)
    mw, sw = quantization.quantize(w, qw)
    return (mx, sx), (mw, sw), qx.scale * qw.scale


def bitexact_gemm_int(mag_a: torch.Tensor, sign_a: torch.Tensor, mag_b: torch.Tensor,
                      sign_b: torch.Tensor, *, n: int, t: int,
                      fix_to_1: bool = True) -> torch.Tensor:
    """Bit-exact signed approximate GEMM on integer sign-magnitude operands.

    mag_a (M, K), mag_b (K, N) integer magnitudes, signs in {-1, 0, 1};
    returns (M, N) float32.  The plain body of ``kernels.lut_matmul`` on
    the operands' device: every product from the (2^n, 2^n) table (n <= 8),
    summed as exact integers and converted once, so it equals the
    reference's float32 sum wherever that sum is exact (|sum| < 2^24).
    """
    lut = artifacts.product_lut_u16(n, t, fix_to_1, mag_a.device)
    return lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, n=n)


def seqmul_gemm_int(mag_a: torch.Tensor, sign_a: torch.Tensor, mag_b: torch.Tensor,
                    sign_b: torch.Tensor, *, n: int, t: int, approx: bool = True,
                    fix_to_1: bool = True) -> torch.Tensor:
    """The split-word recurrence as a GEMM (n <= 12): the plain body of
    ``kernels.seqmul_matmul``, exact integer sums converted once."""
    return seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, n=n, t=t, approx=approx,
                               fix_to_1=fix_to_1)


@contextlib.contextmanager
def substitute_kernels(**kernels):
    """Within, the CUDA bodies below call the given functions in place of
    the kernel entry points of the same names (``lut_matmul``,
    ``seqmul_matmul``, ``packed_matmul``, ``pack_i16_pairs``,
    ``lowrank_matmul``): the static certifier's carrier-faithful bodies
    (``analysis.contracts``) and the FLOP counter's single ops
    (``launch.hlo_analysis``) trace the routes through it."""
    module = globals()
    unknown = sorted(set(kernels) - {"lut_matmul", "seqmul_matmul", "packed_matmul",
                                     "pack_i16_pairs", "lowrank_matmul"})
    if unknown:
        raise ValueError(f"no kernel entry point named {unknown} in the CUDA bodies")
    saved = {name: module[name] for name in kernels}
    module.update(kernels)
    try:
        yield
    finally:
        module.update(saved)


# ------------------------------------------------------------ mode bodies
def _row(p) -> Optional[sharding.Axis]:
    """The model axis a row shard's partial sums are added over, or None."""
    return p.shard.axis if p.shard is not None and p.shard.role == "row" else None


def _int_sum(acc: torch.Tensor, p) -> torch.Tensor:
    """An integer GEMM's result as float32: a row shard's exact integer
    partials added over the model group in int64 first (the module's
    note), converted once."""
    ax = _row(p)
    if ax is not None:
        acc = sharding.all_reduce(acc.to(torch.int64), ax)
    return acc.to(torch.float32)


def _float_sum(out: torch.Tensor, p) -> torch.Tensor:
    """A float GEMM's row-shard partials summed over the model group."""
    return sharding.reduce_from(out, _row(p))


def _exact_ref(x, w, p):
    return _float_sum(x @ w, p)


def _bitexact_ref(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    lut = artifacts.product_lut_u16(p.n, p.t, p.fix_to_1, x.device)
    acc = lut_matmul_plain(lut, mx, sx, mw, sw, n=p.n, integer=_row(p) is not None)
    return _int_sum(acc, p) * scale


def _bitexact_cuda(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    lut = artifacts.product_lut_u16(p.n, p.t, p.fix_to_1, x.device)
    acc = lut_matmul(lut, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw, n=p.n,
                     integer=_row(p) is not None)
    return _int_sum(acc, p) * scale


def _seqmul_ref(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    acc = seqmul_matmul_plain(mx, sx, mw, sw, n=p.n, t=p.t, fix_to_1=p.fix_to_1,
                              integer=_row(p) is not None)
    return _int_sum(acc, p) * scale


def _seqmul_cuda(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    acc = seqmul_matmul(
        mx.to(torch.int16), sx, mw.to(torch.int16), sw,
        n=p.n, t=p.t, fix_to_1=p.fix_to_1, integer=_row(p) is not None,
    )
    return _int_sum(acc, p) * scale


def _lowrank_ref(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    u, v, _ = artifacts.svd_factors(p.n, p.t, p.rank, p.fix_to_1, x.device)
    return _float_sum(lowrank_matmul_plain(u, v, mx, sx, mw, sw, n=p.n), p) * scale


def _lowrank_cuda(x, w, p):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    u, v, _ = artifacts.svd_factors(p.n, p.t, p.rank, p.fix_to_1, x.device)
    out = lowrank_matmul(u, v, mx.to(torch.uint8), sx, mw.to(torch.uint8), sw, n=p.n)
    return _float_sum(out, p) * scale


def _inject_prepare(x, w, p, generator):
    """Draw the moment-matched noise, shape (M, N).  Where the rows of x
    are split over ranks, every rank draws the global (M_global, N) noise
    and keeps its own rows, so the draws do not depend on the rank count.
    A column shard draws the global columns too and keeps its own; a row
    shard's K is the whole K (its shards' sum gets the noise once)."""
    mean, std = artifacts.error_moments(p.n, p.t, p.fix_to_1)
    k_dim = x.shape[-1]
    n_cols, col0 = w.shape[-1], 0
    if p.shard is not None and p.shard.role == "row":
        k_dim *= p.shard.axis.size
    elif p.shard is not None:
        col0, n_cols = p.shard.axis.index * n_cols, n_cols * p.shard.axis.size
    m_global, start = sharding.global_rows(x.shape[0])
    z = torch.randn(
        (m_global, n_cols), generator=generator, dtype=torch.float32, device=x.device
    )
    if m_global != x.shape[0] or n_cols != w.shape[-1]:
        z = z[start:start + x.shape[0], col0:col0 + w.shape[-1]]
    return (mean * k_dim + std * math.sqrt(k_dim) * z,)


def _inject_ref(x, w, p, noise):
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    ax = mx.to(torch.float32) * sx.to(torch.float32)
    aw = mw.to(torch.float32) * sw.to(torch.float32)
    if _row(p) is not None:  # exact integers in float32 only while |sum| < 2^24
        acc = (ax.to(torch.float64) @ aw.to(torch.float64)).to(torch.int64)
        return (_int_sum(acc, p) + noise) * scale
    return (ax @ aw + noise) * scale


def _inject_cuda(x, w, p, noise):
    """Draft-tier path: the quantized exact GEMM on int16 lane pairs,
    then the noise.  Integer-exact, so equal to the reference body
    wherever the reference's float32 sums are exact."""
    (mx, sx), (mw, sw), scale = quantize_operands(x, w, p.n, p.shard)
    pa = pack_i16_pairs(mx * sx.to(torch.int32), dim=1)
    pb = pack_i16_pairs(mw * sw.to(torch.int32), dim=0)
    acc = packed_matmul(pa, pb, n=p.n, integer=_row(p) is not None)
    return (_int_sum(acc, p) + noise) * scale


def _fakequant_ref(x, w, p):
    xq = quantization.fake_quant(x, bits=p.n, reduce=_x_reduce(p.shard))
    return _float_sum(xq @ quantization.fake_quant(w, bits=p.n, reduce=_w_reduce(p.shard)), p)


register_mode(ModeSpec(
    name="exact",
    reference=_exact_ref,
    description="plain f32 matmul (baseline)",
))
register_mode(ModeSpec(
    name="bitexact",
    reference=_bitexact_ref,
    cuda=_bitexact_cuda,
    differentiable=False,
    description="faithful paper semantics via the (2^n, 2^n) product LUT",
))
register_mode(ModeSpec(
    name="lowrank",
    reference=_lowrank_ref,
    cuda=_lowrank_cuda,
    differentiable=False,
    description="exact GEMM + rank-r SVD error correction (two GEMMs, one accumulator)",
))
register_mode(ModeSpec(
    name="seqmul",
    reference=_seqmul_ref,
    cuda=_seqmul_cuda,
    differentiable=False,
    description="paper recurrence per product inside the GEMM (no LUT, n <= 12)",
))
register_mode(ModeSpec(
    name="inject",
    reference=_inject_ref,
    prepare=_inject_prepare,
    cuda=_inject_cuda,
    needs_key=True,
    differentiable=False,
    description="moment-matched stochastic error injection (O(1) at scale)",
))
register_mode(ModeSpec(
    name="fakequant",
    reference=_fakequant_ref,
    description="straight-through fake quantization (QAT substrate)",
))

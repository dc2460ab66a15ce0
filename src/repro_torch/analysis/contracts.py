"""Trace contracts for the registered engine surface.

Counterpart of ``repro/analysis/contracts.py``: builds the
:class:`~repro_torch.analysis.spec.TraceSpec` set the audit matrix runs
over.

* :func:`gemm_trace` traces a mode's CUDA route as the engine runs it on
  the card (``ModeSpec.cuda``: the quantizer, the table or factors, the
  kernel call, the scale), with the kernel call standing as its
  carrier-faithful ``audit_body`` (:func:`kernel_bodies`).  So the
  quantizer's clamp is part of the traced dataflow and the magnitudes'
  bounds are derived, not asserted.  K is the largest at which the
  mode's sums stay in int32, so the proof covers the int32 choice of
  ``build.wide_accumulator`` at its edge.  With ``shards`` it traces a
  row-parallel route instead: K cut into that many shards, each shard's
  kernel call taking its integer epilogue, their exact sums added in
  int64 (the model group's all-reduce, ``engine/modes.py``), converted
  once and scaled, so the K shards' intervals and the int64 sum are
  certified before a tier may launch them.
* :func:`attention_trace` traces the approximate attention's function
  (``approx_attention_plain``: quantization, the key blocks, the online
  softmax, the table and ``U[p_int]`` gathers) at two key blocks.
* :func:`kernel_trace` is the kernel-level contract of each module's
  ``audit_trace``, past the wrappers' eager guards, so the dispatch
  bounds (seqmul's carriers, packed ``2n <= 31``, two words through
  n = 16) are rediscovered; the ``*_int`` kinds are the three integer
  GEMMs' integer epilogues (the accumulator is the output).
"""

from __future__ import annotations

import torch

from repro_torch.analysis.spec import TraceSpec, ValueRange, sds

__all__ = ["KERNEL_KINDS", "attention_trace", "gemm_trace", "kernel_bodies", "kernel_trace"]

_CPU = torch.device("cpu")
_ROWS, _COLS = 4, 32  # the GEMM traces' M and N (their shapes change no envelope)


def _route_k(mode: str, n: int) -> int:
    """K of a mode's route trace: the largest whose sums stay int32."""
    from repro_torch.kernels import lowrank_matmul, lut_matmul, packed_matmul, seqmul_matmul

    if mode == "bitexact":
        return lut_matmul.int32_k_limit(n)
    if mode == "seqmul":
        return max(1, seqmul_matmul.int32_k_limit(n))
    if mode == "inject":
        return max(2, packed_matmul.int32_k_limit(n) // 2 * 2)
    return 2 * lowrank_matmul.max_k_chunk(n)


def kernel_bodies():
    """Within, ``engine.modes``' CUDA bodies call each kernel's
    carrier-faithful ``audit_body`` in place of its wrapper (on a CPU
    tensor a wrapper would take its plain version, whose int64 sums would
    prove nothing of the kernel's int32 stages).  The accumulator width is
    chosen as each wrapper chooses it."""
    from repro_torch.engine import modes
    from repro_torch.kernels import lowrank_matmul, lut_matmul, packed_matmul, seqmul_matmul
    from repro_torch.kernels.build import wide_accumulator

    def lut(table, ma, sa, mb, sb, *, n=8, integer=False):
        wide = wide_accumulator(ma.shape[1], (1 << (2 * n)) - 1)
        return lut_matmul.audit_body(table, ma, sa, mb, sb, n=n, wide=wide, integer=integer)

    def seqmul(ma, sa, mb, sb, *, n, t, approx=True, fix_to_1=True, integer=False):
        wide = wide_accumulator(ma.shape[1], (1 << (2 * n)) - 1)
        return seqmul_matmul.audit_body(ma, sa, mb, sb, n=n, t=t, wide=wide, approx=approx,
                                        fix_to_1=fix_to_1, integer=integer)

    def packed(la, lb, *, n=15, integer=False):
        wide = wide_accumulator(la.shape[1], ((1 << n) - 1) ** 2)
        return packed_matmul.audit_body(la, lb, n=n, wide=wide, integer=integer)

    def lowrank(u, v, ma, sa, mb, sb, *, n=8):
        plan = lowrank_matmul.launch_plan(ma.shape[0], ma.shape[1], mb.shape[1], n)
        return lowrank_matmul.audit_body(u, v, ma, sa, mb, sb, n=n, k_chunk=plan.k_chunk)

    return modes.substitute_kernels(lut_matmul=lut, seqmul_matmul=seqmul, packed_matmul=packed,
                                    pack_i16_pairs=packed_matmul.audit_pack,
                                    lowrank_matmul=lowrank)


def _warm_artifacts(mode: str, n: int, t: int, rank: int = 8) -> None:
    """Build a route's table or factors outside the trace: one built inside
    it would be traced, and its numpy steps cannot be.  Raises
    ``ValueError`` for a table that cannot be built (the uint16 table past
    n = 8, any table past the cap of ``core.luts``)."""
    from repro_torch.engine import artifacts

    if mode == "bitexact":
        artifacts.product_lut_u16(n, t, True, _CPU)
    elif mode == "lowrank":
        artifacts.svd_factors(n, t, rank, True, _CPU)


class _RouteSpec(TraceSpec):
    """A :class:`TraceSpec` traced with the kernel calls as their bodies."""

    def trace(self) -> torch.fx.GraphModule:
        with kernel_bodies():
            return super().trace()


def _row_route(mode: str, n: int, t: int, shards: int):
    """The row-parallel route of an integer mode over ``shards`` K shards,
    as ``engine.modes`` runs it on each rank: the operands quantized whole
    (the absmax global over the model group), each shard's kernel call with
    its integer epilogue, the shards' sums added in int64, one conversion,
    the scale (and ``inject``'s noise once, after the sum)."""
    from repro_torch.analysis.carrier import carrier
    from repro_torch.engine import artifacts, modes

    def fn(x, w, *extra):
        (mx, sx), (mw, sw), scale = modes.quantize_operands(x, w, n)
        kl = x.shape[1] // shards
        total = None
        for r in range(shards):
            a, b = slice(r * kl, (r + 1) * kl), slice(r * kl, (r + 1) * kl)
            if mode == "bitexact":
                lut = artifacts.product_lut_u16(n, t, True, x.device)
                acc = modes.lut_matmul(lut, mx[:, a].to(torch.uint8), sx[:, a],
                                       mw[b].to(torch.uint8), sw[b], n=n, integer=True)
            elif mode == "seqmul":
                acc = modes.seqmul_matmul(mx[:, a].to(torch.int16), sx[:, a],
                                          mw[b].to(torch.int16), sw[b], n=n, t=t, integer=True)
            else:
                pa = modes.pack_i16_pairs(mx[:, a] * sx[:, a].to(torch.int32), dim=1)
                pb = modes.pack_i16_pairs(mw[b] * sw[b].to(torch.int32), dim=0)
                acc = modes.packed_matmul(pa, pb, n=n, integer=True)
            acc = acc.to(torch.int64)
            total = acc if total is None else total + acc
        total = carrier(total, 64, True, "engine/modes.py: the model group's int64 sum of the "
                                         "shards' integer partials")
        out = total.to(torch.float32)
        if extra:
            out = out + extra[0]
        return out * scale

    return fn


def gemm_trace(mode: str, n: int, t: int, *, rank: int = 8,
               shards: int | None = None) -> TraceSpec | None:
    """The CUDA route of ``mode`` at (n, t) as the engine runs it, or
    ``None`` for a mode without a kernel (its reference body runs on every
    backend: nothing to certify).  Operands are unconstrained float32.
    ``shards`` traces the row-parallel route over that many K shards (the
    integer modes only, ``engine.dispatch.INTEGER_MODES``)."""
    from repro_torch.engine import modes
    from repro_torch.engine.dispatch import INTEGER_MODES

    spec = modes.get_mode(mode)
    if spec.cuda is None:
        return None
    if shards is not None and mode not in INTEGER_MODES:
        raise ValueError(f"a row-parallel route adds integer partials; mode {mode!r} adds "
                         f"float32 ones (integer modes: {INTEGER_MODES})")
    try:
        _warm_artifacts(mode, n, t, rank)
        refused = None
    except ValueError as e:  # the route cannot run: a static rejection when traced
        refused = e
    k = _route_k(mode, n)
    if shards is not None:  # whole shards, each of whole packed words
        step = 2 * shards
        k = max(step, k // step * step)
    p = modes.GemmParams(n=n, t=t, fix_to_1=True, rank=rank)
    args = [sds((_ROWS, k), torch.float32), sds((k, _COLS), torch.float32)]
    if spec.prepare is not None:  # inject: its noise, drawn outside the kernel
        args.append(sds((_ROWS, _COLS), torch.float32))
    body = (lambda x, w, *extra: spec.cuda(x, w, p, *extra)) if shards is None else \
        _row_route(mode, n, t, shards)

    def fn(x, w, *extra):
        if refused is not None:
            raise refused
        return body(x, w, *extra)

    name = f"gemm:{mode}[n={n},t={t}{f',row-shards={shards}' if shards else ''}]"
    return _RouteSpec(name=name, fn=fn, args=args, exact_products=mode != "lowrank",
                      facts={"k": k, **({"shards": shards} if shards else {})})


def attention_trace(mode: str, n: int, t: int, *, heads: int = 4, kv: int = 2,
                    head_dim: int = 64, rank: int = 8) -> TraceSpec:
    """The approximate attention's function at (n, t) over two key blocks of
    the mode's block size, causal, query groups of 2: the quantizers, the
    online softmax's running max and the table / ``U[p_int]`` gathers are
    on the traced path."""
    from repro_torch.kernels.approx_attention import approx_attention_plain, attn_tiles

    _warm_artifacts(mode, n, t, rank)  # n <= 8 (``validate_attn_mode``)
    bk = attn_tiles(mode)[1]
    seq = 2 * bk

    def fn(q, k, v, q_pos, k_pos):
        return approx_attention_plain(q, k, v, q_pos, k_pos, mode=mode, n=n, t=t, rank=rank,
                                      causal=True, bk=bk)

    return TraceSpec(
        name=f"attention:{mode}[n={n},t={t}]",
        fn=fn,
        args=[sds((1, seq, heads, head_dim), torch.float32),
              sds((1, seq, kv, head_dim), torch.float32),
              sds((1, seq, kv, head_dim), torch.float32),
              sds((1, seq), torch.int32), sds((1, seq), torch.int32)],
        ranges=[None, None, None, ValueRange(0.0, float(seq - 1), int_valued=True),
                ValueRange(-1.0, float(seq - 1), int_valued=True)],
        exact_products=mode == "bitexact",
    )


KERNEL_KINDS = ("lut_gemm", "seqmul_gemm", "packed_gemm", "lowrank_gemm", "packed_single",
                "packed_words", "lut_gemm_int", "seqmul_gemm_int", "packed_gemm_int")


def kernel_trace(kind: str, n: int, t: int) -> TraceSpec:
    """The kernel-level contract of ``kind`` (one of :data:`KERNEL_KINDS`)."""
    from repro_torch.kernels import (
        lowrank_matmul, lut_matmul, packed_matmul, seqmul_kernel, seqmul_matmul,
    )

    import functools

    builders = {
        "lut_gemm_int": functools.partial(lut_matmul.audit_trace, integer=True),
        "seqmul_gemm_int": functools.partial(seqmul_matmul.audit_trace, integer=True),
        "packed_gemm_int": functools.partial(packed_matmul.audit_trace, integer=True),
        "lut_gemm": lut_matmul.audit_trace,
        "seqmul_gemm": seqmul_matmul.audit_trace,
        "packed_gemm": packed_matmul.audit_trace,
        "lowrank_gemm": lowrank_matmul.audit_trace,
        "packed_single": seqmul_kernel.audit_trace_packed,
        "packed_words": seqmul_kernel.audit_trace_words,
    }
    if kind not in builders:
        raise ValueError(f"unknown kernel trace kind {kind!r}; known: {sorted(builders)}")
    return builders[kind](n=n, t=t)

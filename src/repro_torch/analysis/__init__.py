"""Static certification of the port's CUDA kernels (the aten-graph auditor).

Counterpart of ``repro/analysis``, which traces the Pallas kernels to
jaxprs.  The paper's segmented-carry design gives every intermediate a
known bit width (t-bit LSP words, deferred carries of weight 2^t, 2n-bit
products); this package turns those facts into checked facts about what
the card runs.  Each engine mode's CUDA route is fake-traced to an aten
``torch.fx`` graph (nothing executes), with every kernel call standing as
its carrier-faithful body (``audit_body`` in each module of ``kernels/``,
its values marked with the words of the ``.cu`` file), and audited by
three passes:

``overflow``  interval abstract interpretation (``analysis.interp``):
              no intermediate leaves its carrier (int32 accumulators,
              int64 partials where ``build.wide_accumulator`` says so,
              uint16 tables, int16 lanes in int32 words, the n + 1 planes
              of the recurrence's state); an aten op without a transfer
              function gates;
``gather``    every table index inside its table, proven end to end from
              the quantizer's clamp;
``smem``      every block within Hopper's shared memory, threads and
              registers (``analysis.smem``; registers from the build's
              ``-Xptxas -v`` log on the card).

``analysis.audit`` runs the passes over the mode x tier matrix;
``launch/analyze.py`` is the CLI; ``engine.config.resolve_t`` keeps only
certified splits and ``REPRO_STATIC_AUDIT=1`` makes dispatch refuse an
uncertified launch.  The audit modules are imported on first use here,
since they import the engine, which imports the kernels.
"""

from repro_torch.analysis.domain import F32_EXACT_INT, Interval
from repro_torch.analysis.interp import AuditPolicy, Finding, interpret
from repro_torch.analysis.spec import TraceSpec, ValueRange

__all__ = [
    "AuditPolicy", "AuditResult", "CertificationError", "F32_EXACT_INT", "Finding", "Interval",
    "SMEM_PER_BLOCK", "TileBudgetError", "TraceSpec", "ValueRange", "audit_kernel",
    "audit_matrix", "certified", "interpret", "matrix_entries", "report", "require_certified",
    "validate_tiles",
]

_LAZY = {
    "AuditResult": "audit", "CertificationError": "audit", "audit_kernel": "audit",
    "audit_matrix": "audit", "certified": "audit", "matrix_entries": "audit",
    "report": "audit", "require_certified": "audit", "SMEM_PER_BLOCK": "smem",
    "TileBudgetError": "smem", "validate_tiles": "smem",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"repro_torch.analysis.{_LAZY[name]}"), name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")

"""Hopper's per-block budgets: shared memory, threads, registers (the third pass).

Counterpart of ``repro/analysis/vmem.py``.  The TPU kernels' budget is
VMEM; on the H100 a block may use 227 KB (232,448 bytes) of shared memory,
at most 1,024 threads and 255 registers a thread, and an SM holds 65,536
registers, 228 KB of shared memory and 2,048 threads among its blocks
(NVIDIA's Hopper tuning guide; CUDA's occupancy rules).  One model serves
every wrapper, built on their own launch plans and ``smem_bytes``
(``kernels.lut_matmul``, ``seqmul_matmul``, ``packed_matmul``,
``lowrank_matmul``, ``flash_attention``, ``approx_attention``):

* :func:`validate_tiles` checks a GEMM mode's tile at (n, t) and raises
  :class:`TileBudgetError` naming them; ``engine.config.kernel_tiles``
  calls it on every dispatch.
* :func:`validate_attention` checks the approximate attention's block at
  its smallest row tile; ``kernels.approx_attention`` calls it before any
  plan (lowrank at head width 256, rank 24, needs 292,240 bytes: refused).
* :func:`built_report` reads the registers, spills and static shared
  memory of every instantiation from a built library's ``-Xptxas -v`` log
  (``kernels.build`` keeps it beside the library) and puts each beside the
  most dynamic shared memory and the most threads its wrapper launches it
  with: static + dynamic <= 232,448 bytes, registers x threads <= 65,536,
  and the blocks an SM holds.  Registers exist only where a library was
  built (on the card); elsewhere they are "not measured".
"""

from __future__ import annotations

import dataclasses
import re
import shutil
import subprocess
from typing import Optional

import torch

from repro_torch.kernels.build import SMEM_PER_BLOCK

__all__ = [
    "MAX_REGS_PER_THREAD", "MAX_THREADS_PER_BLOCK", "REGS_PER_SM", "SMEM_PER_BLOCK",
    "SMEM_PER_SM", "Footprint", "TileBudgetError", "attention_footprints", "blocks_per_sm",
    "built_report", "gemm_footprint", "ptxas_report", "validate_attention", "validate_tiles",
]

SMEM_PER_SM = 233_472  # 228 KB of shared memory an SM holds among its blocks
SMEM_RESERVED_PER_BLOCK = 1_024  # the runtime's own share of each block's
REGS_PER_SM = 65_536
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_BLOCK = 1_024
MAX_THREADS_PER_SM = 2_048
MAX_BLOCKS_PER_SM = 32
REG_ALLOC_UNIT = 256  # registers are allocated to a warp in units of 256


class TileBudgetError(ValueError):
    """A launch configuration over a Hopper block's budget, or a tile the
    kernel is not built for."""


@dataclasses.dataclass(frozen=True)
class Footprint:
    """One block of one kernel configuration against Hopper's limits."""

    kernel: str
    config: str
    threads: int
    smem: int  # dynamic shared memory, bytes
    static_smem: int = 0
    registers: Optional[int] = None  # a thread's, from ptxas; None: not measured
    spill_bytes: Optional[int] = None

    @property
    def smem_total(self) -> int:
        return self.smem + self.static_smem

    @property
    def within(self) -> bool:
        regs_ok = self.registers is None or (
            self.registers <= MAX_REGS_PER_THREAD and self.registers * self.threads <= REGS_PER_SM)
        return (self.smem_total <= SMEM_PER_BLOCK and self.threads <= MAX_THREADS_PER_BLOCK
                and regs_ok)

    @property
    def blocks_per_sm(self) -> int:
        return blocks_per_sm(self.threads, self.smem_total, self.registers)

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "config": self.config, "threads": self.threads,
                "smem": self.smem, "static_smem": self.static_smem,
                "registers": self.registers, "spill_bytes": self.spill_bytes,
                "smem_limit": SMEM_PER_BLOCK, "within": self.within,
                "blocks_per_sm": self.blocks_per_sm}


def blocks_per_sm(threads: int, smem: int, registers: Optional[int] = None) -> int:
    """Blocks of this footprint an SM holds at once (CUDA's occupancy
    rules: threads, shared memory with the runtime's reserve, registers
    allocated per warp in units of 256; registers not measured leave only
    the first two)."""
    by = [MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // max(threads, 1),
          SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)]
    if registers:
        per_warp = -(-registers * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
        by.append(REGS_PER_SM // (per_warp * -(-threads // 32)))
    return max(0, min(by))


# ------------------------------------------------------------- the GEMMs
def _gemm_module(mode: str):
    from repro_torch.kernels import lowrank_matmul, lut_matmul, packed_matmul, seqmul_matmul

    mods = {"bitexact": lut_matmul, "seqmul": seqmul_matmul, "inject": packed_matmul,
            "lowrank": lowrank_matmul}
    if mode not in mods:
        raise ValueError(f"mode {mode!r} has no CUDA GEMM kernel; modes with one: {sorted(mods)}")
    return mods[mode]


def gemm_footprint(mode: str, n: int, tiles: tuple, rank: int = 8) -> Footprint:
    """A block of ``mode``'s GEMM kernel at tile ``(bm, bn)`` and bit width
    ``n`` (``rank``: lowrank's tables)."""
    mod = _gemm_module(mode)
    bm, bn = tiles
    smem = {"bitexact": lambda: mod.smem_bytes(n, bm),
            "seqmul": lambda: mod.smem_bytes(n, bm, bn),
            "inject": lambda: mod.smem_bytes(bm),
            "lowrank": lambda: mod.smem_bytes(n, bm, rank)}[mode]()
    return Footprint(mod.KERNEL.name, f"n={n}, bm={bm}, bn={bn}"
                     + (f", rank={rank}" if mode == "lowrank" else ""), mod.THREADS, smem)


def validate_tiles(mode: str, n: int, t: int, tiles: tuple, *, rank: int = 8) -> Footprint:
    """Check ``mode``'s GEMM tile ``(bm, bn)`` at (n, t): positive powers of
    two, one of the tiles the kernel is built for, a block within Hopper's
    shared memory and threads.  Raises :class:`TileBudgetError` naming
    the (mode, n, t), before any launch."""
    bm, bn = tiles
    where = f"{mode} at n={n}, t={t}" + (f", rank={rank}" if mode == "lowrank" else "")
    for name, v in (("bm", bm), ("bn", bn)):
        if v <= 0 or v & (v - 1):
            raise TileBudgetError(f"{where}: tile {name}={v} must be a positive power of two")
    mod = _gemm_module(mode)
    if tuple(tiles) not in mod.TILES:
        raise TileBudgetError(f"{where}: tile (bm={bm}, bn={bn}) is not one the kernel is built "
                              f"for ({mod.TILES})")
    fp = gemm_footprint(mode, n, tiles, rank)
    if fp.smem_total > SMEM_PER_BLOCK:
        raise TileBudgetError(f"{where}: {fp.smem_total} bytes of shared memory per block at "
                              f"tile (bm={bm}, bn={bn}), over the {SMEM_PER_BLOCK} a Hopper block "
                              f"may use")
    if fp.threads > MAX_THREADS_PER_BLOCK:
        raise TileBudgetError(f"{where}: {fp.threads} threads a block, over "
                              f"{MAX_THREADS_PER_BLOCK}")
    return fp


# ------------------------------------------------------------ attention
def validate_attention(mode: str, n: int, hd: int, rank: int) -> Footprint:
    """The approximate attention's block at its smallest row tile (bitexact
    TM = 1; lowrank at ``rank``) must fit; raises :class:`TileBudgetError`
    with the byte count."""
    from repro_torch.kernels import approx_attention as aa

    tm = aa._TMS[-1]
    nbytes = aa.smem_bytes(mode, n, hd, rank, tm=tm)
    fp = Footprint(f"approx_attention_{mode}", f"n={n}, hd={hd}, rank={rank}",
                   aa._BITEXACT_THREADS if mode == "bitexact" else aa._LOWRANK_THREADS, nbytes)
    if nbytes > SMEM_PER_BLOCK:
        raise TileBudgetError(f"approx attention ({mode}, n={n}, hd={hd}, rank={rank}) needs "
                              f"{nbytes} bytes of shared memory, over {SMEM_PER_BLOCK}")
    return fp


def attention_footprints(hd: int, dtype: torch.dtype, *, b: int = 4, s: int = 1024,
                         t: int = 4096, h: int = 16, kv: int = 8, sms: int = 132) -> list:
    """The exact attention kernels' blocks (forward, decode, dq, dk/dv) at
    head width ``hd`` and ``dtype`` from their launch plans."""
    from repro_torch.kernels import flash_attention as fa

    out = []
    for kernel, name in (("fwd", "flash_attention"), ("decode", "flash_decode"),
                         ("dq", "flash_attention_bwd_dq"), ("dkv", "flash_attention_bwd_dkv")):
        plan = fa.launch_plan(kernel, b, 1 if kernel == "decode" else s, t, h, kv, hd, dtype,
                              sms)
        out.append(Footprint(name, f"hd={hd}, {str(dtype).replace('torch.', '')}, "
                             f"b={b}, s={s}, t={t}, h={h}, kv={kv}", plan.threads, plan.smem))
    return out


# ---------------------------------------------------- built instantiations
def ptxas_report(log: str) -> list:
    """``[(kernel, registers, spill store bytes, spill load bytes, static
    shared-memory bytes)]`` per instantiation from nvcc's ``-Xptxas -v``
    log, names demangled where a demangler is installed."""
    rows = []
    for chunk in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        rows.append([chunk.split("'")[0], int(regs.group(1)) if regs else None,
                     *(map(int, spill.groups()) if spill else (None, None)),
                     int(smem.group(1)) if smem else 0])
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool and rows:
        names = subprocess.run([tool], input="\n".join(r[0] for r in rows), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for row, name in zip(rows, names):
                row[0] = re.sub(r"\(anonymous namespace\)::|\(.*", "", name.replace("void ", ""))
    return [tuple(r) for r in rows]


def _launch_limits() -> dict:
    """``{kernel symbol: (most threads, most dynamic shared memory)}`` a
    wrapper launches each kernel with, over every configuration it accepts
    (GEMMs: every tile, n <= 8, seqmul n <= 12, lowrank rank 8; attention:
    every built head width and dtype, bitexact at its largest row tile that
    fits, lowrank rank 8)."""
    from repro_torch.kernels import approx_attention as aa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lowrank_matmul, lut_matmul, packed_matmul, seqmul_matmul

    def most(kernel, **kw):
        return max(fa.smem_bytes(kernel, hd, dt, kw.get("s", 32768), kw.get("t", 32768), 16)
                   for hd in fa.HEAD_DIMS for dt in (torch.bfloat16, torch.float32))

    def fwd_threads():
        return max(fa._fwd_groups(dt, hd) * fa.FWD_THREADS * fa._halves(hd)
                   for hd in fa.HEAD_DIMS for dt in (torch.bfloat16, torch.float32))

    def dkv_threads():
        return max(fa._groups(dt, hd) * fa.GROUP_THREADS * fa._halves(hd)
                   for hd in fa.HEAD_DIMS for dt in (torch.bfloat16, torch.float32))

    fits = lambda xs: max(x for x in xs if x <= SMEM_PER_BLOCK)  # noqa: E731
    return {
        "lut_matmul_kernel": (lut_matmul.THREADS,
                              max(lut_matmul.smem_bytes(8, bm) for bm, _ in lut_matmul.TILES)),
        "seqmul_matmul_kernel": (seqmul_matmul.THREADS, max(
            seqmul_matmul.smem_bytes(12, bm, bn) for bm, bn in seqmul_matmul.TILES)),
        "packed_matmul_kernel": (packed_matmul.THREADS, max(
            packed_matmul.smem_bytes(bm) for bm, _ in packed_matmul.TILES)),
        "lowrank_matmul_kernel": (lowrank_matmul.THREADS, max(
            lowrank_matmul.smem_bytes(8, bm, 8) for bm, _ in lowrank_matmul.TILES)),
        "flash_attention_kernel": (fwd_threads(), most("fwd")),
        "flash_decode_kernel": (fa.DEC_THREADS, most("decode", s=1)),
        "bwd_dq_kernel": (fa.DQ_ROWS // 16 * 32, most("dq")),
        "bwd_dkv_kernel": (dkv_threads(), most("dkv")),
        "bitexact_kernel": (aa._BITEXACT_THREADS, fits(
            aa.smem_bytes("bitexact", 8, hd, 8, tm) for hd in fa.HEAD_DIMS for tm in aa._TMS)),
        "lowrank_kernel": (aa._LOWRANK_THREADS, fits(
            aa.smem_bytes("lowrank", 8, hd, 8) for hd in fa.HEAD_DIMS)),
        "seqmul_packed_kernel": (256, 0),
        "seqmul_words_kernel": (256, 0),
    }


def built_report(logs: dict[str, str]) -> list[Footprint]:
    """Every built instantiation's block against Hopper's limits, from
    ``{source: ptxas log}`` (``kernels.build.build_all``'s result, or
    :func:`built_logs`).  Raises ``KeyError`` for a kernel no wrapper
    launches (a new kernel must be given its limits here)."""
    limits = _launch_limits()
    out = []
    for source, log in sorted(logs.items()):
        for name, regs, spill_st, spill_ld, static in ptxas_report(log):
            key = next((k for k in limits if k in name), None)
            if key is None:
                raise KeyError(f"{source}: no launch limits for the instantiation {name!r}")
            threads, smem = limits[key]
            spill = None if spill_st is None else spill_st + spill_ld
            out.append(Footprint(key, name, threads, smem, static, regs, spill))
    return out


def built_logs(names=None) -> dict[str, str]:
    """The ``-Xptxas -v`` logs of the built libraries (built first where
    stale, so this needs ``nvcc``)."""
    from repro_torch.kernels import build

    names = tuple(names or build.KERNELS)
    build.build_all(names)
    return {n: build.library_path(n).with_suffix(".log").read_text() for n in names}

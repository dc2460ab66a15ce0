"""Build and bind the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point.  It is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``)
and loaded with ``ctypes``.  The library name carries a hash of the
source, so an edited kernel is never served from a stale build.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing here runs at import: the CPU tests import every
module of the port, and this machine may have no ``nvcc`` at all.

A :class:`CudaKernel` is a kernel's binding: it checks the C function's
return code (the launch's ``cudaGetLastError()``) and counts launches.
Several kernels may share one source (``flash_attention.cu`` holds the
prefill and decode kernels); each has its own binding and count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = [
    "BLOCK_COLS", "BLOCK_K", "BLOCK_ROWS", "BUILD_DIR", "CSRC", "KERNELS", "LOWRANK_BLOCK_K",
    "SMEM_PER_BLOCK", "CudaKernel", "block_rows", "build_all", "check_operand", "nvcc_path",
    "wide_accumulator",
]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# one entry per source under csrc/ (a source may hold several kernels)
KERNELS = (
    "lut_matmul", "seqmul_matmul", "packed_matmul", "lowrank_matmul",
    "flash_attention", "flash_attention_bwd", "approx_attention", "seqmul_kernel",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the toolkit")


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS) -> dict:
    """Compile every stale kernel at once; returns ``{name: compiler log}``
    (``-Xptxas -v`` register and shared-memory report) for those built."""
    with _lock:
        started = {n: _start(n) for n in names if not _target(n).exists()}
        logs, failed = {}, []
        for name, (proc, tmp, out) in started.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


class CudaKernel:
    """One kernel's C entry point, its error check and its launch count.

    ``launches`` goes up by one for each launch CUDA accepted and
    nowhere else, so a run can show that it went through the kernel.
    """

    def __init__(self, name: str, symbol: str, argtypes: list, source: str | None = None):
        self.name, self.symbol, self.argtypes = name, symbol, argtypes
        self.source = source or name  # csrc/<source>.cu
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point with ``args``, then the device index and
        PyTorch's current stream on that device (its last two parameters)."""
        fn = self._bind()
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, index, stream)
        if err != 0:
            msg = self._lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} ({msg})")
        self.launches += 1


def check_operand(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
                  device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# Block tiles shared by the three GEMM kernels (csrc/*.cu): BM rows by 64
# output columns, K staged 32 at a time.  Each wrapper picks BM from M with
# block_rows(), the one place that choice is made.
BLOCK_ROWS = (4, 16, 64)
BLOCK_COLS = 64
BLOCK_K = 32
LOWRANK_BLOCK_K = 16  # csrc/lowrank_matmul.cu stages K 16 at a time
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use on Hopper


def block_rows(m: int) -> int:
    """The smallest row tile that holds ``m`` rows, else the largest."""
    return next((bm for bm in BLOCK_ROWS if m <= bm), BLOCK_ROWS[-1])


def wide_accumulator(k: int, max_product: int) -> bool:
    """Whether a K-term integer sum of products up to ``max_product`` needs
    int64 (int32 holds it while ``k * max_product < 2^31``)."""
    return k * max_product >= 1 << 31

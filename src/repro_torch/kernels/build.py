"""Build and bind the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point.  It is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``)
and loaded with ``ctypes``.  The library name carries a hash of the
source, so an edited kernel is never served from a stale build.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  ``--split-compile=0`` lets each ``nvcc`` optimise its
kernels on every core, so the slowest source (``seqmul_matmul.cu``, 67
instantiations) does not hold the build on one core once the others are
done.  Nothing here runs at import: the CPU tests import every
module of the port, and this machine may have no ``nvcc`` at all.

A :class:`CudaKernel` is a kernel's binding: it checks the C function's
return code (the launch's ``cudaGetLastError()``) and counts launches.
Several kernels may share one source (``flash_attention.cu`` holds the
prefill and decode kernels); each has its own binding and count.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

__all__ = [
    "BUILD_DIR", "CSRC", "KERNELS", "SMEM_PER_BLOCK", "SPLIT_BLOCKS_PER_SM", "CudaKernel",
    "audit_armed", "audit_gate", "build_all", "check_operand", "device_index", "float_scratch",
    "library_path", "nvcc_path", "pick_tile", "sm_count", "sm_count_of", "split_k",
    "tile_counters", "wide_accumulator", "workspace_bytes",
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is built (the hash of its
    source and of the shared ``csrc/*.cuh`` headers in the name)."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS, seconds: dict | None = None) -> dict:
    """Compile every stale kernel at once; returns ``{name: compiler log}``
    (``-Xptxas -v`` register and shared-memory report) for those built.
    ``seconds``, where given, gets each one's wall seconds from the start."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names if not library_path(n).exists()}

        def finish(name):
            log, _ = started[name][0].communicate()
            return log, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(max(1, len(started))) as pool:
            done = dict(zip(started, pool.map(finish, started)))
        logs, failed = {}, []
        for name, (proc, tmp, out) in started.items():
            log, wall = done[name]
            logs[name] = log
            if seconds is not None:
                seconds[name] = wall
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
                lib = ctypes.CDLL(str(library_path(name)))
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

    def library(self) -> ctypes.CDLL:
        """The built library of this kernel's source (compiled at first use)."""
        self._bind()
        return self._lib

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


def audit_armed() -> bool:
    """Whether ``REPRO_STATIC_AUDIT=1`` is set: the dispatch gate is on."""
    return os.environ.get("REPRO_STATIC_AUDIT") == "1"


def audit_gate(kernel: str, what: str, n: int = 0, t: int = 0, **config) -> None:
    """The dispatch gate before a launch of ``kernel``: with the gate on
    (:func:`audit_armed`), ``analysis.audit.gate`` refuses a configuration
    the static audit has not certified; otherwise nothing."""
    if audit_armed():
        from repro_torch.analysis import audit

        audit.gate(kernel, what, n, t, **config)


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


SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use on Hopper

SPLIT_BLOCKS_PER_SM = 2  # the split-K GEMMs' grids fill one wave of this many blocks per SM


def pick_tile(m: int, tiles: tuple) -> tuple[int, int]:
    """The ``(BM, BN)`` of ``tiles`` for ``m`` rows: the smallest token tile
    that holds them, else the largest."""
    return next((tile for tile in tiles if m <= tile[0]), tiles[-1])


def split_k(tiles: int, k: int, *, step: int, min_chunk: int, sms: int,
            max_chunk: int | None = None,
            per_sm: int = SPLIT_BLOCKS_PER_SM) -> tuple[int, int]:
    """``(splits, chunk)``: K cut into ``splits`` slices of ``chunk`` (a
    multiple of ``step``; the last slice may be shorter, none is empty).

    Splits as far as ``tiles * splits`` stays within one wave of
    ``per_sm`` blocks per SM (:data:`SPLIT_BLOCKS_PER_SM`, or 1 for a
    persistent grid of one block per SM) and slices of at least
    ``min_chunk`` allow; no slice is longer than ``max_chunk`` where one is
    given.  A grid of 8-24 output tiles at decode would otherwise leave
    most of the 132 SMs idle, and a second, mostly empty wave would double
    the time.
    """
    if k <= 0:
        return 1, step
    want = max(1, per_sm * sms // tiles)
    splits = max(1, min(want, k // min_chunk))
    chunk = -(-k // splits)
    chunk = -(-chunk // step) * step
    if max_chunk is not None:
        chunk = min(chunk, max_chunk // step * step)
    return -(-k // chunk), chunk


def workspace_bytes(splits: int, m: int, n_cols: int, wide: bool) -> int:
    """Bytes of an integer GEMM's split-K workspace: one partial (int64 if
    ``wide``) per split and output; none without a split."""
    return 0 if splits == 1 else splits * m * n_cols * (8 if wide else 4)


def _device_key(device: torch.device) -> tuple[str, int]:
    if device.index is not None:
        return device.type, device.index
    return device.type, torch.cuda.current_device() if device.type == "cuda" else 0


def device_index(device: torch.device) -> int:
    """The index of a CUDA ``device`` (the current one where it names none)."""
    return _device_key(device)[1]


@functools.lru_cache(maxsize=None)
def sm_count_of(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA ``device``."""
    return sm_count_of(device_index(device))


_counters: dict = {}


def tile_counters(device: torch.device, count: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``count`` split-K tile counters.

    A split-K kernel's last block of each tile sets that tile's counter
    back to 0 before the kernel ends, so the buffer is zeroed once, when
    it is first made or grown, and serves every later launch on the stream
    (launches on one stream never overlap).
    """
    key = _device_key(device)
    buf = _counters.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


_scratch: dict = {}


def float_scratch(device: torch.device, count: int) -> torch.Tensor:
    """A float32 buffer of at least ``count`` elements for a kernel's
    partials, kept per device and grown when a launch needs more.

    Nothing in it outlives a launch: the kernel writes every partial before
    it reads one.  Launches on one stream never overlap, so one buffer
    serves every launch there, with no allocation per call.
    """
    key = _device_key(device)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.empty(max(count, 1 << 16), dtype=torch.float32, device=device)
        _scratch[key] = buf
    return buf


def wide_accumulator(k: int, max_product: int) -> bool:
    """Whether a K-term integer sum of products up to ``max_product`` needs
    int64 (int32 holds it while ``k * max_product < 2^31``)."""
    return k * max_product >= 1 << 31

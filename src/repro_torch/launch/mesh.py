"""Meshes: the production meshes to size, the host's mesh to run on, the card's constants.

Counterpart of ``repro/launch/mesh.py``.  Functions, never module-level
constants, so importing this module touches no process group.

- :func:`make_production_mesh`: the reference's 16 x 16 = 256-device pod
  and its 2 x 16 x 16 = 512-device two-pod mesh, as an
  :class:`~repro_torch.distributed.sharding.AbstractMesh`: axis sizes, no
  process group (the dry-run sizes them; nothing runs on them).
- :func:`make_host_mesh`: a live ``DeviceMesh`` over every rank of the
  default process group, shaped (data = world size, model = 1).
- :func:`join_mesh`: join a ``torchrun`` job and make its (data, model)
  mesh, as the train and serve CLIs' ``--mesh DATA,MODEL`` do.
- :class:`HW`: the roofline constants of one NVIDIA H100 80GB HBM3 (SXM5),
  in place of the reference's TPU v5e numbers.
"""

from __future__ import annotations

import os

import torch

from repro_torch.distributed.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_host_mesh", "join_mesh", "HW"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 = 256 devices a pod; x 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def join_mesh(spec: str, device: torch.device):
    """Join the ``torchrun`` job (``env://``; NCCL on the card, gloo on the
    CPU) and make its (data, model) mesh from ``spec`` ``"DATA,MODEL"``,
    whose product must be the job's world size; ValueError otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    try:
        dims = tuple(int(x) for x in spec.split(","))
    except ValueError:
        dims = ()
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"--mesh takes DATA,MODEL, got {spec!r}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dims[0] * dims[1] != world:
        raise ValueError(f"--mesh {spec} needs {dims[0] * dims[1]} ranks; the job has "
                         f"{world} (torchrun --nproc-per-node)")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not torch.distributed.is_initialized():
        torch.distributed.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return init_device_mesh(device.type, dims, mesh_dim_names=("data", "model"))


def make_host_mesh(device=None):
    """Every rank of the default process group: (data = n, model = 1), on
    ``device``'s type (default ``cuda``).  Needs an initialized group."""
    if not torch.distributed.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized torch.distributed "
                           "process group (init_process_group, or torchrun)")
    from torch.distributed.device_mesh import init_device_mesh

    n = torch.distributed.get_world_size()
    device_type = torch.device(device).type if device is not None else "cuda"
    return init_device_mesh(device_type, (n, 1), mesh_dim_names=("data", "model"))


class HW:
    """NVIDIA H100 80GB HBM3 (SXM5) constants for the roofline terms
    (NVIDIA's data sheet; the card's own name and power limit print beside
    every measurement)."""

    NAME = "NVIDIA H100 80GB HBM3"
    PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s per card
    HBM_BW = 3.35e12  # B/s per card
    NVLINK_BW = 450e9  # B/s per direction per card (NVLink 4, 18 links)
    HBM_BYTES = 80e9  # device memory per card

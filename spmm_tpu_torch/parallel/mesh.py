"""Device mesh helpers (port of ``spmm_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``; PyTorch
runs one process per rank (SPMD), so the port's mesh is PyTorch's own
``torch.distributed.device_mesh.DeviceMesh`` over an initialised process
group.  Rank r sits at the row-major coordinate r of the mesh shape, as
device r does in JAX's ``devices.reshape(shape)``.  Collectives are NCCL on
the card and gloo on the CPU; a mesh whose backend does not fit its device
raises instead of copying through the host.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spmm_tpu_torch.formats.containers import compute_device

#: the process-group backend each mesh device type takes
BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def _check_backend(device_type: str) -> None:
    want = BACKEND_OF.get(device_type)
    if want is None:
        raise ValueError(f"no distributed backend for device type {device_type!r}")
    have = str(dist.get_backend())
    if want not in have:
        raise ValueError(
            f"a {device_type} mesh needs the {want} backend, but the process group runs "
            f"{have!r}: its collectives would copy through the host"
        )


def make_mesh(
    shape: Sequence[int] | int | None = None,
    axis_names: Sequence[str] = ("rows",),
    *,
    device="cuda",
) -> DeviceMesh:
    """Build a mesh over the ranks of the initialised process group.

    ``make_mesh()`` → 1-D mesh over all ranks on axis "rows";
    ``make_mesh((r, c), ("rows", "cols"))`` → 2-D row×col mesh.  A smaller
    shape takes the first ranks, as JAX's takes the first devices.  Every
    rank of the group calls it (building the axes' groups is collective).
    The card is the default; ``device="cpu"`` builds a gloo mesh."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() or "
            "torch.distributed.init_process_group() on every rank first"
        )
    device_type = torch.device(device).type
    _check_backend(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    axis_names = tuple(axis_names)[: len(shape)]
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} does not match mesh shape {shape}")
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: ``cuda:<current>`` on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_on_mesh(mesh: DeviceMesh, t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on the mesh's device type (NCCL takes CUDA
    tensors only; a CUDA tensor on a gloo mesh would cross the host)."""
    if t.device.type != mesh.device_type:
        raise ValueError(
            f"{what} lies on {t.device.type}, the mesh on {mesh.device_type}: move it to "
            f"the mesh's device first (no silent copy through the host)"
        )


def free_port() -> int:
    """A TCP port free on this host now, for a ``tcp://127.0.0.1:<port>``
    or ``MASTER_PORT`` rendezvous made by the caller."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(*, retries: int = 5, backoff_s: float = 2.0, device="cuda") -> None:
    """Multi-process bootstrap (no-op for a single process): the default
    process group from the launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), with retry and exponential
    back-off, since rendezvous at start-up is racy and a transient connect
    failure should not kill the job.  NCCL with ``cuda:$LOCAL_RANK`` as this
    rank's device, unless ``device="cpu"`` asks for gloo.  No-op when a group
    is already initialised or ``MASTER_ADDR`` is absent."""
    if dist.is_initialized():
        return  # already initialised by the launcher
    if "MASTER_ADDR" not in os.environ:
        return  # single process
    device_type = compute_device(device).type
    backend = BACKEND_OF[device_type]
    kw = {}
    if device_type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kw["device_id"] = local
    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(backend, init_method="env://", **kw)
            return
        except (RuntimeError, ValueError, TimeoutError, OSError) as e:
            last = e
            time.sleep(backoff_s * (2**attempt))
    raise RuntimeError(
        f"torch.distributed.init_process_group failed after {retries} attempts"
    ) from last

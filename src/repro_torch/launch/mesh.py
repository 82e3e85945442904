"""The process world and its meshes.

The reference is one controller over many devices; the port is one process
per device, so before any mesh there is a world to join: ``init_world``
joins it (NCCL on the card, gloo on the CPU, never one in place of the
other), ``make_host_mesh`` / ``make_production_mesh`` lay the reference's
named meshes over its ranks as ``DeviceMesh``es, and ``destroy_world``
leaves it.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.devices import resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_world(device="cuda", store_path: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group: NCCL for ``cuda`` (the default), gloo for
    ``cpu``; ``backend`` names another explicitly (gloo over CUDA tensors:
    two ranks on one card, which NCCL refuses; gloo then raises for a
    collective it does not run on CUDA tensors).  Where ``torchrun`` set ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` the world comes from them; otherwise
    from a ``FileStore`` at ``store_path`` shared by ``world_size`` ranks,
    this one ``rank``.  On the card each rank takes device ``LOCAL_RANK``
    (else its rank) modulo the visible devices.  Returns (rank, world
    size)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if all(k in os.environ for k in _TORCHRUN_ENV):
        rank = int(os.environ["RANK"])
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://")
    else:
        if store_path is None or rank is None or world_size is None:
            raise ValueError("without torchrun's environment, init_world "
                             "needs store_path, rank and world_size")
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    return dist.get_rank(), dist.get_world_size()


def destroy_world() -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the world (every rank calls it, as jax.make_mesh
    takes the first devices); raises where the world is smaller.  The
    reference's named meshes below, and any other (the ``pod`` mesh of the
    compressed gradient sync)."""
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {tuple(shape)} mesh {tuple(axes)} needs {n} "
                         f"ranks; the world has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's v5e-256 pod mesh: (data=16, model=16); multi-pod
    adds pod=2 outermost."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """Small ("data", "model") mesh over the world's ranks (tests /
    examples), clamped to the world as the reference clamps to the host's
    devices."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return make_mesh((data, model), ("data", "model"), device)


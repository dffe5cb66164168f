"""Device meshes over the ranks of a torch.distributed world.

Counterpart of the JAX package's ``parallel/mesh.py``. There a
``jax.sharding.Mesh`` names the axes and XLA inserts the collectives; here the
ranks of the world (one process per device) are laid out on a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes, and the
code calls the collectives itself (``collectives.py``) on each axis's group.

Axes, as in the JAX package:
  data  - batch sharding (each rank serves its rows of the batch).
  model - tensor parallelism of the UNet's projections (``sharding_rules.py``).
  sp    - height sharding of the activations (``spatial.py``).

Every rank runs the same program on its shard (SPMD). Its device is explicit:
``cuda:{local_rank}`` under NCCL, ``cpu`` under gloo. The process group must be
initialised first (``launch.py`` does it for spawned ranks; under ``torchrun``
call ``init_from_env``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# A collective that waits longer raises: a lost rank ends the run, not hangs
# it.
TIMEOUT = timedelta(minutes=30)
# How long the other ranks of a trainer wait for rank 0's lone work of an
# epoch (validation, checkpoints, the train state), which JAX's single
# controller does not bound; a rank that dies still ends the wait, since its
# socket closes.
LONE_WORK_TIMEOUT = timedelta(days=7)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh over the world's ranks, and this rank's place and device."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device

    def size(self, axis: Optional[str]) -> int:
        """The axis's size; 1 for None (an axis the layout does not use)."""
        if axis is None:
            return 1
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        return self.shape[self.axis_names.index(axis)]

    def coordinate(self, axis: Optional[str]) -> int:
        """This rank's index along ``axis`` (0 for None)."""
        if axis is None:
            return 0
        return self.device_mesh.get_coordinate()[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's row along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate_of(self, rank: int, axis: str) -> int:
        """Rank ``rank``'s index along ``axis`` (ranks are laid out row-major)."""
        i = self.axis_names.index(axis)
        return (rank // math.prod(self.shape[i + 1:])) % self.shape[i]


def rank_device(backend: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank}`` under NCCL (raises where
    there is no such card), ``cpu`` under gloo."""
    if backend == "nccl":
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {local_rank} finds no CUDA device for NCCL "
                               f"({torch.cuda.device_count()} visible)")
        return torch.device("cuda", local_rank)
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unknown backend {backend!r}: use 'nccl' or 'gloo'")


def init_from_env(backend: str) -> torch.device:
    """Join the world that ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) over ``backend``; returns the rank's
    device."""
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = rank_device(backend, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT,
                                **kw)
    return device


def lone_work_group():
    """A gloo group of every rank, bounded by ``LONE_WORK_TIMEOUT``: the others
    wait in ``dist.barrier(group=...)`` on it while rank 0 works alone, and
    the default group's collectives keep ``TIMEOUT``. Every rank must call it,
    in the same order."""
    return dist.new_group(backend="gloo", timeout=LONE_WORK_TIMEOUT)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every rank of the initialised world. Default: 1-D data
    parallelism over all ranks. ``shape=(dp, tp)`` with
    ``axis_names=("data", "model")`` for 2-D layouts. Every rank must call it,
    in the same order as every other mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = tuple(int(n) for n in (shape if shape is not None else (world,)))
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != #devices {world}")
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
              else torch.device("cpu"))
    dm = init_device_mesh(device.type, shape, mesh_dim_names=axis_names)
    return Mesh(dm, axis_names, shape, device)


def local_batch_size(global_batch: int, mesh: Mesh, axis: str = "data") -> int:
    n = mesh.size(axis)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {axis}={n}")
    return global_batch // n


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "data") -> torch.Tensor:
    """This rank's rows of a [B, ...] tensor along ``axis``, on the rank's
    device; the whole batch for None."""
    n = local_batch_size(x.shape[0], mesh, axis) if axis is not None else x.shape[0]
    i = mesh.coordinate(axis)
    return x[i * n:(i + 1) * n].to(mesh.device)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank holds the whole of ``x``, on its device."""
    return x.to(mesh.device)

"""Meshes: the host's ranks, and the production meshes of the dry-run.

Counterpart of ``repro.launch.mesh``.  A ``DeviceMesh`` needs a process
group, and a process has one default group:

* :func:`start_process_group` starts this process's rank of a real group
  (NCCL on the card, ``gloo`` on the CPU) from a ``file://`` store, which
  needs no network; :func:`make_host_mesh` lays a ``("data", "model")`` mesh
  over its ranks;
* :func:`make_production_mesh` builds the reference's production meshes,
  ``(16, 16)`` ``("data", "model")`` or ``(2, 16, 16)`` ``("pod", "data",
  "model")``, over a *fake* group of 256 or 512 ranks in which this process
  is rank 0 and no collective moves data.  It is for the dry-run only, which
  runs in its own process (its CLI), never beside a real group.  The fake
  group comes from ``torch.testing._internal.distributed.fake_pg``, a
  private module of PyTorch: this is the one place the port imports it.

Importing this module starts no group; only the functions do.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the dry-run's meshes by name: shape and axis names
DRYRUN_MESHES = {
    "1gpu": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def start_process_group(device: str, rank: int, world_size: int, init_file: str) -> None:
    """Join a group of ``world_size`` ranks as ``rank``: NCCL on ``cuda``
    (rank ``r`` on card ``r``), ``gloo`` on ``cpu``; the ranks meet through
    the file ``init_file``, which must not exist before the first joins."""
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the group that exists
    (``model`` of them on the model axis)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: start_process_group first")
    n = dist.get_world_size()
    model = min(model, n)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n // model, model), mesh_dim_names=("data", "model"))


def fake_mesh(shape: Sequence[int], names: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` over a fake group of as many ranks, this process
    rank 0.  An existing fake group of another size is replaced; a real
    group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore   # private

    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group exists in this process: the dry-run's "
                               "fake meshes run in a process of their own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    return fake_mesh(*DRYRUN_MESHES["2x16x16" if multi_pod else "16x16"])


def make_dryrun_mesh(name: str) -> DeviceMesh:
    """One of :data:`DRYRUN_MESHES`; ``1gpu`` is the card's own one-rank mesh."""
    return fake_mesh(*DRYRUN_MESHES[name])

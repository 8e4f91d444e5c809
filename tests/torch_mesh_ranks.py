"""Rank functions of the meshed trainer's multi-rank tests.

Each runs as one rank of a ``gloo`` group on the CPU, started by
``tests/test_torch_launch.py`` with ``torch.multiprocessing`` (spawn) and
meeting through a file store, so no network is needed.  This module imports
torch and the port only, never JAX: the ranks load no JAX.  Every rank
gathers what it computed to full tensors (a collective) and rank 0 writes
them to ``out_dir`` for the test to compare.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import start_process_group
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer
from repro_torch.sharding import Sharding, distribute, unshard

torch.set_num_threads(1)

ARCH = "stablelm_3b"
STEPS = 3
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)


def config():
    return dataclasses.replace(tconfigs.reduced_config(ARCH), dtype=torch.float32)


def data_config():
    return DataConfig(vocab=config().vocab, seq_len=16, global_batch=8, seed=3)


def trainer(mesh, ckpt_dir, fsdp=True, microbatches=1, checkpoint_every=0):
    tcfg = TrainConfig(steps=STEPS, microbatches=microbatches, checkpoint_every=checkpoint_every,
                       checkpoint_dir=ckpt_dir, fsdp=fsdp, attn_impl="chunked")
    return Trainer(config(), OPT, tcfg, data_config(), device="cpu", mesh=mesh)


def _full(tree):
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().numpy()
            for k, v in tree.items()}


def _save(out_dir, name, rank, **arrays):
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)


def _run(mesh, out_dir, name, rank, **kw):
    out = trainer(mesh, os.path.join(out_dir, f"ck_{name}"), **kw).run()
    _save(out_dir, name, rank, losses=np.array(out["losses"]),
          **{f"p.{k}": v for k, v in _full(out["params"]).items()},
          **{f"mu.{k}": v for k, v in _full(out["opt_state"]["mu"]).items()},
          **{f"nu.{k}": v for k, v in _full(out["opt_state"]["nu"]).items()})
    return out


def two_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """data=2 with fsdp: 3 steps (saved at step 3), the same with 2
    microbatches, then the step-3 checkpoint restored under a ``(1, 2)``
    mesh without fsdp."""
    start_process_group("cpu", rank, 2, init_file)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        _run(mesh, out_dir, "data2", rank, checkpoint_every=STEPS)
        _run(mesh, out_dir, "data2_mb2", rank, microbatches=2)
        tr = trainer(mesh, os.path.join(out_dir, "ck_data2"), fsdp=False)
        tr.remesh(init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model")))
        params, opt = tr.init_state()
        opt, step = tr._restore(params, opt)
        local_shapes = {k: list(p.to_local().shape) for k, p in params.items()}
        _save(out_dir, "restored_1x2", rank, step=np.array(step),
              local_shapes=np.array(json.dumps(local_shapes)),
              **{f"p.{k}": v for k, v in _full(params).items()},
              **{f"mu.{k}": v for k, v in _full(opt["mu"]).items()},
              **{f"nu.{k}": v for k, v in _full(opt["nu"]).items()})
    finally:
        dist.destroy_process_group()


def four_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """fsdp on ``(data=2, model=2)`` and on ``(pod=2, data=2, model=1)``
    (the embed axis over two mesh axes), 3 steps each; and the batch rows
    that ``("pod", "data")`` gives each rank, gathered back and their
    gradient summed over both axes."""
    start_process_group("cpu", rank, 4, init_file)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        _run(mesh, out_dir, "data2_model2", rank)
        pods = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
        _run(pods, out_dir, "pod2_data2", rank)

        full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        s = Sharding(pods, (("pod", "data"), None))
        block = distribute(full, s)
        local = block.to_local().clone().requires_grad_(True)
        whole = unshard(local, s)
        (whole * whole).sum().backward()
        coord = pods.get_coordinate()
        _save(out_dir, "batch_rows", rank, coord=np.array(coord),
              local=local.detach().numpy(), gathered=whole.detach().numpy(),
              grad=local.grad.numpy(), full_tensor=block.full_tensor().numpy())
        rows = [None] * 4
        dist.all_gather_object(rows, [rank, list(coord), local.detach().numpy().tolist()])
        _save(out_dir, "batch_rows_all", rank, rows=np.array(json.dumps(rows)))
    finally:
        dist.destroy_process_group()

"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

Counterpart of ``repro.launch.train``, with its flags.  PyTorch uses a
device by running one process (one rank) on it: by default the CLI runs one
rank on the card (NCCL, a ``(data=1, model=1)`` mesh); ``--nproc N`` spawns
N ranks (on the CPU: ``gloo``, which the tests use), meeting through a file
store.  ``--smoke`` trains the reduced config of the chosen architecture.
``--warmup-steps`` and ``--data-seed`` set what the reference leaves at the
defaults of ``AdamWConfig`` and ``DataConfig``.  Rank 0 prints the
reference's two lines, then one JSON line: the losses, each step's seconds,
on the card the peak of device memory, and the CUDA kernels' launch counts
(0: training runs no forward-only kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, param_count, reduced_config
from ..data import DataConfig
from ..kernels import flash_attention as fa
from ..kernels import mamba2_ssd as ssd
from ..optim import AdamWConfig
from ..runtime import TrainConfig, Trainer
from .mesh import make_host_mesh, start_process_group


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS + [a.replace("_", "-") for a in ARCH_IDS])
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=AdamWConfig.warmup_steps)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nproc", type=int, default=1, help="ranks (one a device)")
    return ap.parse_args(argv)


def run_rank(rank: int, args: argparse.Namespace, init_file: str) -> None:
    """One rank: join the group, train on the host mesh, leave the group."""
    start_process_group(args.device, rank, args.nproc, init_file)
    try:
        arch = args.arch.replace("-", "_")
        cfg = reduced_config(arch) if args.smoke else get_config(arch)
        if rank == 0:
            print(f"arch {cfg.name} ({cfg.family}): {param_count(cfg)/1e6:.1f}M params", flush=True)
        mesh = make_host_mesh()
        trainer = Trainer(
            model_cfg=cfg,
            opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                                total_steps=args.steps),
            train_cfg=TrainConfig(
                steps=args.steps,
                microbatches=args.microbatches,
                checkpoint_every=args.ckpt_every,
                checkpoint_dir=args.ckpt_dir,
                remat=args.remat,
                fsdp=args.fsdp,
                attn_impl="xla" if args.seq_len <= 2048 else "chunked",
            ),
            data_cfg=DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                global_batch=args.global_batch, seed=args.data_seed),
            device=args.device,
            mesh=mesh,
        )
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = trainer.run()
        losses = out["losses"]
        if rank == 0:
            print(f"trained {out['final_step']} steps; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
                  f"restarts={out['restarts']} stragglers={out['stragglers']}", flush=True)
            print(json.dumps({
                "arch": cfg.name, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "fsdp": args.fsdp, "remat": args.remat, "microbatches": args.microbatches,
                "final_step": out["final_step"], "losses": losses,
                "step_seconds": out["step_seconds"], "restarts": out["restarts"],
                "peak_memory_gb": (torch.cuda.max_memory_allocated() / 2**30
                                   if args.device == "cuda" else None),
                "kernel_launches": {"flash_attention": fa.flash_attention.launches,
                                    "mamba2_ssd": ssd.mamba2_ssd.launches},
            }), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.nproc < 1:
        raise SystemExit("--nproc must be at least 1")
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        init_file = os.path.join(tmp, "store")
        if args.nproc == 1:
            run_rank(0, args, init_file)
        else:
            torch.multiprocessing.start_processes(run_rank, args=(args, init_file),
                                                  nprocs=args.nproc, start_method="spawn")


if __name__ == "__main__":
    main()

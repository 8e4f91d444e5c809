"""Quickstart on the port: train a small model end to end, on the GPU by default.

The counterpart of ``examples/quickstart.py`` over ``repro_torch`` alone: the
same configs (reduced stablelm_3b, 60 steps, checkpoints every 20) through
the port's ``Trainer`` on a one-rank mesh (NCCL on the card, ``gloo`` on the
CPU), the same lines printed and the same check that the loss falls.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Without a CUDA device and without ``--device cpu`` it raises before any work.
"""

import argparse
import os
import tempfile
from typing import Any, Dict

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_host_mesh, start_process_group
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer


def configs(checkpoint_dir: str) -> Dict[str, Any]:
    """The ``Trainer``'s configs (its keyword arguments but the mesh)."""
    cfg = reduced_config("stablelm_3b")
    return dict(
        model_cfg=cfg,
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
        train_cfg=TrainConfig(
            steps=60, checkpoint_every=20, checkpoint_dir=checkpoint_dir, attn_impl="xla"
        ),
        data_cfg=DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8),
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device that trains (default cuda; raises without one)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        start_process_group(dev.type, 0, 1, os.path.join(tmp, "group"))
        try:
            trainer = Trainer(**configs(os.path.join(tmp, "ckpt")), mesh=make_host_mesh())
            out = trainer.run()
        finally:
            dist.destroy_process_group()
    losses = out["losses"]
    print(f"steps: {out['final_step']}  restarts: {out['restarts']}")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training should reduce loss"
    print("OK")


if __name__ == "__main__":
    main()

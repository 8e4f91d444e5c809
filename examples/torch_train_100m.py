"""End to end on the port: train a ~100M-parameter model for a few hundred steps.

The counterpart of ``examples/train_100m.py`` over ``repro_torch`` alone: the
same scaled-down granite-style dense transformer, deterministic synthetic
corpus, AdamW with cosine schedule, gradient accumulation, periodic async
checkpoints, fault tolerance on and straggler detector armed, through the
port's ``Trainer`` on a one-rank mesh (NCCL on the card, ``gloo`` on the
CPU).  A ``--ckpt`` that already holds a checkpoint resumes from it.

Where it departs from the reference's example, and only there: it takes
``--device``; ``--ckpt`` defaults to ``repro_100m`` in the temporary
directory (``$TMPDIR``) where the reference's is ``/tmp/repro_100m``; its
"done in" line names the device (and on ``cuda`` the card) where the
reference's names ``jax.default_backend()``; its tokens/s counts the steps
this run computed, not ``--steps`` (which over-counts after a resume); a
resume with no step left prints ``no step left: resumed at step N from DIR``
(the reference's indexes its empty loss list and raises); and it ends in
``OK``, as the port's other examples do.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 2 --batch 2 --seq 32

Without a CUDA device and without ``--device cpu`` it raises before any work.
"""

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, param_count
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_host_mesh, start_process_group
from repro_torch.models import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer


def model_100m() -> ModelConfig:
    # ~100M params: 12L x 512 x 8H, ff 2048, 32k vocab
    return dataclasses.replace(
        get_config("granite_8b"),
        name="granite_100m",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=2048,
        vocab=32_000,
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_100m"))
    ap.add_argument("--device", default="cuda",
                    help="device that trains (default cuda; raises without one)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = model_100m()
    print(f"model: {cfg.name}, {param_count(cfg)/1e6:.0f}M params")
    with tempfile.TemporaryDirectory() as tmp:
        start_process_group(dev.type, 0, 1, os.path.join(tmp, "group"))
        try:
            trainer = Trainer(
                model_cfg=cfg,
                opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps),
                train_cfg=TrainConfig(
                    steps=args.steps,
                    microbatches=2,
                    checkpoint_every=100,
                    checkpoint_dir=args.ckpt,
                    attn_impl="chunked",
                    remat="dots",
                    log_every=20,
                ),
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
                mesh=make_host_mesh(),
                straggler_callback=lambda s, dt: print(f"  [straggler] step {s}: {dt:.2f}s"),
            )
            t0 = time.time()
            out = trainer.run()
            dt = time.time() - t0
        finally:
            dist.destroy_process_group()
    losses = out["losses"]
    # the steps this run computed: none where --ckpt already held the last step
    tok_s = len(losses) * args.batch * args.seq / dt
    on = f"{dev.type}, {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else dev.type
    print(f"done in {dt:.0f}s ({tok_s:.0f} tok/s on {on})")
    for i in range(0, len(losses), max(1, len(losses) // 10)):
        print(f"  step {i:4d}  loss {losses[i]:.3f}")
    if losses:
        print(f"  final loss {losses[-1]:.3f} (started {losses[0]:.3f})")
    else:
        print(f"  no step left: resumed at step {out['final_step']} from {args.ckpt}")
    print("OK")


if __name__ == "__main__":
    main()

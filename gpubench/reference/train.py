"""The plain reference of a training step: float32 loss, gradients and AdamW.

The optimizer is written here from its equations, as the workload file
states them: gradients clipped by their global norm, Adam moments with bias
correction, decoupled weight decay, and a learning rate warmed up linearly
then decayed on a cosine.  The loss is the configuration's reference
module's ``train_loss``.  Nothing of the program is imported.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Optional

import torch

from gpubench import harness

#: the reference a caller that names none trains: the dense and MoE families'
model = harness.reference_module(harness.DEFAULT_REFERENCE)


def learning_rate(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def run_steps(run: Dict, opt: Dict, params: Dict[str, torch.Tensor], batches: List[Dict],
              precision: str = "fp32", ref: Optional[ModuleType] = None) -> Dict[str, object]:
    """Trains the float32 ``params`` (updated in place) on ``batches`` (one
    row each: ``tokens``, ``targets``) through the reference module ``ref``'s
    loss.  Returns each step's loss and the first step's gradient norm by
    leaf, before clipping."""
    ref = ref or model
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        for p in params.values():
            p.requires_grad_(True)
        loss = ref.train_loss(run, params, batch["tokens"], batch["targets"], precision)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norms = {k: float(g.norm()) for k, g in zip(params, grads)}
            if first_grad is None:
                first_grad = norms
            gnorm = math.sqrt(sum(n * n for n in norms.values()))
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            lr = learning_rate(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            bias1, bias2 = 1 - b1 ** step, 1 - b2 ** step
            for (k, p), g in zip(params.items(), grads):
                p.requires_grad_(False)
                g = g * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (mu[k] / bias1) / ((nu[k] / bias2).sqrt() + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
            del grads
    return {"losses": losses, "first_grad": first_grad}

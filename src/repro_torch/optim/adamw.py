"""AdamW + the cosine schedule over a dict of parameters.

Counterpart of ``repro.optim.adamw``: explicit functions, not
``torch.optim.AdamW``, whose moments take each parameter's dtype (bfloat16
here) where the reference keeps them in float32.  Moments are float32;
parameters may be bfloat16 (each update is computed in float32 and rounded
once).  A "tree" here is a flat ``name -> tensor`` dict (the model's state
dict names); the optimizer state mirrors it.  The update writes into the
parameters and moments it is given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``; a float32 scalar, computed in
    float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params: Params) -> Dict[str, object]:
    """Zero float32 moments ``mu`` / ``nu`` shaped as ``params``, and an int32
    step ``count`` of 0, on the parameters' device."""
    first = next(iter(params.values()))
    return {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    """``sqrt`` of the sum of every element's square, in float32."""
    total = None
    for x in tree.values():
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Params, grads: Params, state: Mapping[str, object],
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[Params, Dict[str, object], Dict[str, torch.Tensor]]:
    """One step, **in place**: gradients clipped by their global norm to
    ``grad_clip``, moments updated, bias-corrected, and the decoupled weight
    decay applied with the scheduled learning rate:

        g = grad * min(1, clip / max(|grads|, 1e-9))
        mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
        p = p - lr (mu_hat / (sqrt(nu_hat) + eps) + wd p)

    The parameters and moments are overwritten (no second copy of the model
    or its moments; the reference returns new trees).  Returns ``(params,
    new state, {"grad_norm", "lr"})``, the state holding the same moments and
    the new count.  ``grad_norm`` is the global norm where ``grads`` are each
    rank's blocks of larger tensors (the meshed trainer computes it over the
    mesh); it defaults to :func:`global_norm` of ``grads``."""
    count = state["count"] + 1
    dev = count.device
    lr = cosine_schedule(cfg, count)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.minimum(_f32(1.0, dev), cfg.grad_clip / torch.clamp_min(gnorm, 1e-9))
    c = count.to(torch.float32)
    bias1 = 1 - _f32(cfg.b1, dev) ** c
    bias2 = 1 - _f32(cfg.b2, dev) ** c
    for k, p in params.items():
        mu, nu = state["mu"][k], state["nu"][k]
        g = grads[k].float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        del g
        step = (mu / bias1).div_((nu / bias2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        step.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(p32.sub_(step))   # for a float32 p, p32 is p: copy_ then does nothing
        del step, p32
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}

"""The ssm family (mamba2-370m), the reference's ``ssm`` branch of ``repro.models``.

The embedding, the stacked ``mamba.*`` layers (:func:`repro_torch.models.mamba2.run_stack`),
the final RMSNorm and the tied head.  The decode state is every layer's SSM and conv
state, no KV cache.  No layer is recomputed under ``remat``, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..sharding import WHOLE, ModelAxis, Product
from . import common, mamba2
from .common import rms_norm
from .hybrid import lm_head_loss
from .transformer import ModelConfig, embed

#: the decode state's leaves besides ``pos``
STATE = ("ssm", "conv")
#: the head is the embedding's transpose
TIED_HEAD = True
#: the leaves kept in float32 whatever ``cfg.dtype``
FLOAT32_LEAVES = tuple(f"mamba.{k}" for k in mamba2.FP32_LEAVES)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    layer = mamba2.layer_shapes(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return {
        "embed": (cfg.vocab, cfg.d_model),
        **{f"mamba.{k}": (cfg.n_layers,) + s for k, s in layer.items()},
        "final_ln": (cfg.d_model,),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    return {"embed": ("vocab", "embed_tbl"),
            **{f"mamba.{k}": ("layers",) + a for k, a in mamba2.layer_axes().items()},
            "final_ln": ("embed",)}


def split_products(cfg: ModelConfig) -> Dict[str, Product]:
    """The SSM heads (:func:`repro_torch.models.mamba2.split_products`) and
    the tied vocabulary's rows."""
    return {**mamba2.split_products(cfg), "vocab": Product({"embed": 0}, cfg.vocab)}


def fill_params(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                generator: torch.Generator) -> None:
    """Draws ``params`` **in place** from ``generator``, as the reference
    does: the embedding from a plain normal, the final norm zero."""
    for part in common.draw_blocks(params["embed"], common.DRAW_BLOCK):
        part.copy_(torch.randn(part.shape, generator=generator, device=generator.device)
                   .mul_(0.02))
    mamba2.fill_mamba_layers({k.split(".", 1)[1]: v for k, v in params.items()
                              if k.startswith("mamba.")}, generator, cfg.d_model)
    params["final_ln"].zero_()


def forward(
    cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
    ssm_states: Optional[torch.Tensor] = None, conv_states: Optional[torch.Tensor] = None,
    decode: bool = False, ssd_impl: str = "chunked", tp: ModelAxis = WHOLE,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(final hidden states, ``{"ssm", "conv"}``).  The states passed in
    are updated in place; without them none is kept (training)."""
    h = embed(params["embed"], tokens, tp).to(cfg.dtype)
    h = mamba2.run_stack(cfg, common.layer_views(params["mamba"]), h, range(cfg.n_layers),
                         ssm_states, conv_states, decode, ssd_impl, tp)
    return rms_norm(h, params["final_ln"]), {"ssm": ssm_states, "conv": conv_states}


def train_loss(cfg, params, batch, *, attn_impl, ssd_impl, remat, tp) -> torch.Tensor:
    h, _ = forward(cfg, params, batch["tokens"], ssd_impl=ssd_impl, tp=tp)
    return lm_head_loss(cfg, params, h, batch["targets"], tp=tp)


def new_state(cfg, batch: int, max_len: int, device, tp: ModelAxis = WHOLE):
    ssm, conv = mamba2.init_states(cfg, batch, device, tp)
    return {"ssm": ssm, "conv": conv}


def prefill(cfg, params, batch, max_len, device, state, *, attn_impl, ssd_impl, tp, check_room):
    state = state or new_state(cfg, batch["tokens"].shape[0], max_len, device, tp)
    return forward(cfg, params, batch["tokens"], state["ssm"], state["conv"], ssd_impl=ssd_impl,
                   tp=tp)


def decode_step(cfg, params, tokens, state, *, attn_impl, ssd_impl, tp, check_room):
    return forward(cfg, params, tokens, state["ssm"], state["conv"], decode=True,
                   ssd_impl=ssd_impl, tp=tp)

"""Unified model API of the port.

Counterpart of ``repro.models``: ``Model`` dispatches on
``ModelConfig.family``.  Ported so far:

* ``dense``  -> :mod:`repro_torch.models.transformer`

The ``moe`` / ``vlm`` / ``ssm`` / ``hybrid`` / ``audio`` families raise
``NotImplementedError`` until their slices land.

``Model`` is an ``nn.Module`` that owns the layer-stacked parameters under the
reference's key names, so ``state_dict()`` / ``load_state_dict()`` speak the
reference's tree (see :mod:`repro_torch.convert`).  The entry points used by
the server:

    init(generator)                 -> self, parameters drawn at random
    prefill(batch, max_len)         -> (hidden, cache_state)
    decode_step(tokens, state)      -> (hidden, new_state)
    logits(hidden)                  -> vocabulary logits
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import transformer
from .transformer import BIG, ModelConfig, MoEConfig

__all__ = ["Model", "ModelConfig", "MoEConfig", "BIG"]

State = Dict[str, Any]

_LATER = {
    "moe": "the MoE slice", "vlm": "the VLM slice", "ssm": "the SSM slice",
    "hybrid": "the hybrid slice", "audio": "the encoder-decoder slice",
}


class Model(nn.Module):
    def __init__(
        self, cfg: ModelConfig, attn_impl: str = "chunked", device: DeviceLike = "cuda"
    ):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: it comes with "
                f"{_LATER.get(cfg.family, 'a later slice')} of the port"
            )
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        # storage only; init() or load_state_dict() gives it values.  This slice
        # serves: the parameters ask for no gradients until the trainer is ported
        self.layers = nn.ParameterDict()
        for name, shape in transformer.param_shapes(cfg).items():
            param = nn.Parameter(
                torch.zeros(shape, dtype=cfg.dtype, device=self.device), requires_grad=False
            )
            if name.startswith("layers."):
                self.layers[name.split(".", 1)[1]] = param
            else:
                self.register_parameter(name, param)

    # -- parameters ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, seed: int = 0) -> "Model":
        """Draw every parameter at random from ``generator`` (one on the
        model's device, seeded with ``seed``, if none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        fresh = transformer.init_params(self.cfg, generator, device=self.device)
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(fresh.pop(name))
        return self

    @property
    def params(self) -> transformer.Params:
        """The parameters as the reference's nested tree (no copy)."""
        return transformer.nest(dict(self.named_parameters()))

    # -- forward paths -----------------------------------------------------------

    def _cache_positions(self, batch: int, max_len: int) -> torch.Tensor:
        return torch.arange(max_len, dtype=torch.int32, device=self.device)[None].expand(
            batch, max_len
        )

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int) -> Tuple[torch.Tensor, State]:
        """Processes the prompt; returns (hidden, decode state).  Attention
        runs over the whole cache: unwritten slots are hidden by ``kp <= qp``."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        caches = transformer.init_kv_cache(self.cfg, B, max_len, device=self.device)
        h, caches = transformer.forward(
            self.cfg, self.params, tokens, attn_impl=self.attn_impl,
            kv_caches=caches, cache_positions=self._cache_positions(B, max_len),
        )
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        return h, {"kv": caches, "pos": pos}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        """One new token per sequence against the cached state.  The KV cache
        in ``state`` is updated in place; the returned state shares it."""
        B = tokens.shape[0]
        kv = state["kv"]
        h, kv = transformer.forward(
            self.cfg, self.params, tokens, positions=state["pos"][:, None],
            attn_impl=self.attn_impl,
            kv_caches=kv, cache_positions=self._cache_positions(B, kv[0].shape[2]),
        )
        return h, {"kv": kv, "pos": state["pos"] + 1}

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return transformer.lm_head(self.cfg, self.params, h)

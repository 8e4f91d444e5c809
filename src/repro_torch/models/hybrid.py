"""Zamba2-style hybrid: Mamba2 backbone + a *shared* attention block.

Counterpart of ``repro.models.hybrid`` (arXiv:2411.15242): a stack of Mamba2
layers, interleaved every ``attn_period`` layers with a full attention block
whose weights are SHARED across all applications.  Each application still
needs its own KV cache (activations differ), so caches are stacked over
applications, not layers.  Where the reference scans, the port loops over
the stacked leading axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import attention
from .common import (
    apply_rope, check_remat, remat_call, rms_norm, rope_sin_cos, swiglu, trunc_normal_,
)
from .mamba2 import fill_mamba_layers, init_states, layer_axes, layer_shapes, run_stack
from .transformer import ModelConfig, _cache_index, check_cache_room, lm_loss

Params = Dict[str, Any]
State = Dict[str, Any]


def n_attn_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_period if cfg.attn_period else 0


def shared_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """``name -> shape`` of the one shared attention block (and its FFN)."""
    D, Hq, Hkv, Dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    return {
        "ln1": (D,), "wq": (D, Hq * Dh), "wk": (D, Hkv * Dh), "wv": (D, Hkv * Dh),
        "wo": (Hq * Dh, D), "ln2": (D,), "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }


def fill_params(
    cfg: ModelConfig, params: Dict[str, torch.Tensor], generator: torch.Generator
) -> None:
    """Draws ``params`` (:func:`param_shapes`' names: ``embed``, the
    ``mamba.*`` stack, one ``shared_attn.*`` set, ``final_ln``) **in place**
    from ``generator``, which lives on their device, as the reference draws
    them (truncated normal, std ``1/sqrt(fan_in)``, 0.02 for ``embed``)."""
    trunc_normal_(params["embed"], generator, 0.02)
    fill_mamba_layers({k.split(".", 1)[1]: v for k, v in params.items()
                       if k.startswith("mamba.")}, generator, cfg.d_model)
    for name in shared_shapes(cfg):
        p = params[f"shared_attn.{name}"]
        if name.startswith("ln"):
            p.zero_()
        else:
            trunc_normal_(p, generator, 1.0 / math.sqrt(p.shape[0]))
    params["final_ln"].zero_()


#: logical axes of the shared block's leaves, the reference's
SHARED_AXES = {
    "ln1": ("embed",), "wq": ("embed", "heads"), "wk": ("embed", "heads"),
    "wv": ("embed", "heads"), "wo": ("heads", "embed"), "ln2": ("embed",),
    "w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed"),
}


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys), the reference's."""
    axes: Dict[str, Tuple[Optional[str], ...]] = {"embed": ("vocab", "embed_tbl")}
    axes.update({f"mamba.{k}": ("layers",) + a for k, a in layer_axes().items()})
    axes.update({f"shared_attn.{k}": a for k, a in SHARED_AXES.items()})
    axes["final_ln"] = ("embed",)
    return axes


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    L = cfg.n_layers
    shapes: Dict[str, Tuple[int, ...]] = {"embed": (cfg.vocab, cfg.d_model)}
    for k, s in layer_shapes(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state).items():
        shapes[f"mamba.{k}"] = (L,) + s
    shapes.update({f"shared_attn.{k}": s for k, s in shared_shapes(cfg).items()})
    shapes["final_ln"] = (cfg.d_model,)
    return shapes


def _shared_attn_block(
    cfg: ModelConfig,
    sp: Dict[str, torch.Tensor],
    h: torch.Tensor,
    positions: torch.Tensor,
    attn_impl: str,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_positions: Optional[torch.Tensor] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One application of the shared block; returns the new hidden states.
    ``kv_cache`` is this application's ``(B, Skv, Hkv, Dh)`` pair and is
    **updated in place** at ``positions[:, 0]`` (the reference returns a new
    pair).  ``rope`` and ``cache_index`` are what :func:`forward` computes
    once for every application; a lone call works them out itself."""
    B, S, _ = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    x = rms_norm(h, sp["ln1"])
    q = (x @ sp["wq"]).reshape(B, S, Hq, Dh)
    k = (x @ sp["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ sp["wv"]).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, sin_cos=rope)
    k = apply_rope(k, positions, cfg.rope_theta, sin_cos=rope)
    if kv_cache is not None:
        ck, cv = kv_cache
        rows, cols = cache_index if cache_index is not None else _cache_index(positions)
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
        k_att, v_att, kv_pos = ck, cv, cache_positions
    else:
        k_att, v_att, kv_pos = k, v, positions
    o = attention(q, k_att, v_att, positions, kv_pos, impl=attn_impl)
    h = h + (o.reshape(B, S, -1) @ sp["wo"]).to(h.dtype)
    x = rms_norm(h, sp["ln2"])
    return h + (swiglu(x @ sp["w_gate"], x @ sp["w_up"]) @ sp["w_down"]).to(h.dtype)


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "chunked",
    ssd_impl: str = "chunked",
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (Apps,B,Skv,Hkv,Dh) x2
    cache_positions: Optional[torch.Tensor] = None,
    ssm_states: Optional[torch.Tensor] = None,   # (L, B, H, P, N)
    conv_states: Optional[torch.Tensor] = None,  # (L, B, D_CONV-1, conv_dim)
    decode: bool = False,
    remat: str = "none",
) -> Tuple[torch.Tensor, State]:
    """Returns (final hidden states, ``{"kv", "ssm", "conv"}``).

    Groups of ``attn_period`` mamba layers, each followed by one application
    of the shared block, then the tail layers when ``n_layers % attn_period``.
    The states and caches passed in are updated **in place** and handed back
    (a prefill passes zeroed ones from :func:`init_states`).  Without
    ``ssm_states`` no state is kept and the returned ones are ``None``: the
    reference makes and returns fresh zeroed states there, which training
    drops.  As in the dense path, a KV insert past the cache's end raises
    ``ValueError`` where the reference clamps.  ``remat`` ``dots`` / ``full``
    recompute each group of mamba layers and its shared-block application in
    backward, as the reference checkpoints its group body (the tail layers,
    as there, are not).
    """
    check_remat(remat)
    B, S = tokens.shape
    h = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    period = cfg.attn_period or (cfg.n_layers + 1)
    apps = n_attn_applications(cfg)
    if kv_caches is not None:
        check_cache_room(positions, S, kv_caches[0].shape[2])
    # the same for every application: computed once
    rope = rope_sin_cos(positions, cfg.dh, cfg.rope_theta) if apps else None
    cache_index = None if kv_caches is None else _cache_index(positions)

    layers = params["mamba"]

    def group(h, app):
        h = run_stack(cfg, layers, h, range(app * period, (app + 1) * period),
                      ssm_states, conv_states, decode, ssd_impl)
        cache = None if kv_caches is None else (kv_caches[0][app], kv_caches[1][app])
        return _shared_attn_block(cfg, params["shared_attn"], h, positions, attn_impl,
                                  kv_cache=cache, cache_positions=cache_positions,
                                  rope=rope, cache_index=cache_index)

    for app in range(apps):
        h = remat_call(group, remat, h, app)
    h = run_stack(cfg, layers, h, range(apps * period, cfg.n_layers),
                  ssm_states, conv_states, decode, ssd_impl)
    h = rms_norm(h, params["final_ln"])
    return h, {"kv": kv_caches, "ssm": ssm_states, "conv": conv_states}


def lm_head_loss(
    cfg: ModelConfig, params: Params, h: torch.Tensor, targets: torch.Tensor, chunk: int = 512
) -> torch.Tensor:
    """The chunked cross-entropy of :func:`repro_torch.models.transformer.lm_loss`
    through the tied head (``embed.T``): zamba2 ties its embedding."""
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    return lm_loss(tied, {"embed": params["embed"]}, h, targets, chunk=chunk)

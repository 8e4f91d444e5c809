"""Zamba2 as published: Mamba2 layers, two shared blocks applied in turn over
the concatenated embedding, and a LoRA adapter and a linear per application.

The port's own family (the reference has none): ``transformers``'
``modeling_zamba2.py`` (``Zamba2ForCausalLM``) equation by equation, at the
configuration's ``zamba2`` group (:class:`repro_torch.models.transformer.Zamba2Config`):

* every layer is a Mamba2 mixer (:func:`repro_torch.models.mamba2.mamba_layer`)
  with ``ssm_groups`` B / C groups and a gated norm a group;
* before the layers of ``hybrid_layer_ids``, application ``j`` runs shared
  block ``j % mem_blocks`` on ``concat(h, e)`` (``e`` the embedding's output,
  so ``2 D`` wide): RMSNorm, causal attention with full rotary and the scale
  ``(Dh / 2) ** -0.5`` where ``Dh = 2 D / n_heads``, the output product to
  ``D``, RMSNorm, ``gate_up`` plus application ``j``'s rank-``adapter_rank``
  LoRA, ``act(gate) * up``, the down product; no residual inside the block.
  Application ``j``'s ``linear`` (``D x D``) then maps it, and it is added to
  the mamba layer's input before that layer's norm, the layer's residual
  being its input without it;
* the final RMSNorm, then the head tied to the embedding.

Every norm's eps is :data:`EPS`.  Each application keeps its own KV cache,
so the caches are stacked over applications; the SSM and conv states over
all layers, as the ssm family's.

Parameters, layer-stacked: ``embed``; ``mamba.*`` (the mamba layers'
leaves at ``ssm_groups`` groups); ``shared.{ln1, wq, wk, wv, wo, ln2,
w_gate_up, w_down}`` stacked over the shared blocks (``ln1`` and the q / k /
v products ``2 D`` wide; ``w_gate_up``'s columns are gate then up);
``apps.{lora_a, lora_b, linear}`` stacked over the applications; ``final_ln``.
Norm scales are stored as offsets from one (the port's ``1 + w``).  Serving
only: the SSD kernel is forward only, and the family splits nothing over a
``model`` axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import WHOLE, ModelAxis
from . import hybrid
from .attention import attention
from .common import apply_rope, layer_views, rms_norm, rope_sin_cos, trunc_normal_
from .mamba2 import fill_mamba_layers, layer_axes, layer_shapes, run_stack
from .transformer import (
    ModelConfig, _cache_index, arange_positions, cache_insert, check_cache_room, embed,
    slot_positions,
)

Params = Dict[str, Any]
State = Dict[str, Any]

#: the decode state's leaves besides ``pos``
STATE = ("kv", "ssm", "conv")
#: the head is the embedding's transpose
TIED_HEAD = True
#: every leaf is held in ``cfg.dtype``, as the published checkpoint holds it
#: (the scan reads ``a_log`` / ``d_skip`` / ``dt_bias`` in float32 all the same)
FLOAT32_LEAVES = ()

#: eps of every norm of the published model (``rms_norm_eps``, and the
#: mixer's gated norm)
EPS = 1e-5

#: ``hidden_act`` of the shared blocks' MLP (``transformers``' ``"gelu"`` is the exact one)
ACTIVATIONS = {"gelu": F.gelu}


def applications(cfg: ModelConfig) -> int:
    return len(cfg.zamba2.hybrid_layer_ids)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    z = cfg.zamba2
    D, L, Hq, Hkv, Dh, F_ = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    M, A, r = z.mem_blocks, applications(cfg), z.adapter_rank
    shapes: Dict[str, Tuple[int, ...]] = {"embed": (cfg.vocab, D)}
    for k, s in layer_shapes(D, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                             z.ssm_groups).items():
        shapes[f"mamba.{k}"] = (L,) + s
    shapes.update({
        "shared.ln1": (M, 2 * D), "shared.wq": (M, 2 * D, Hq * Dh),
        "shared.wk": (M, 2 * D, Hkv * Dh), "shared.wv": (M, 2 * D, Hkv * Dh),
        "shared.wo": (M, Hq * Dh, D), "shared.ln2": (M, D),
        "shared.w_gate_up": (M, D, 2 * F_), "shared.w_down": (M, F_, D),
        "apps.lora_a": (A, D, r), "apps.lora_b": (A, r, 2 * F_), "apps.linear": (A, D, D),
        "final_ln": (D,),
    })
    return shapes


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys)."""
    axes: Dict[str, Tuple[Optional[str], ...]] = {"embed": ("vocab", "embed_tbl")}
    axes.update({f"mamba.{k}": ("layers",) + a for k, a in layer_axes().items()})
    axes.update({
        "shared.ln1": (None, None), "shared.wq": (None, None, "heads"),
        "shared.wk": (None, None, "heads"), "shared.wv": (None, None, "heads"),
        "shared.wo": (None, "heads", "embed"), "shared.ln2": (None, "embed"),
        "shared.w_gate_up": (None, "embed", "ff"), "shared.w_down": (None, "ff", "embed"),
        "apps.lora_a": (None, "embed", None), "apps.lora_b": (None, None, "ff"),
        "apps.linear": (None, "embed", "embed"), "final_ln": ("embed",),
    })
    return axes


def split_products(cfg: ModelConfig):
    raise NotImplementedError(
        f"{cfg.name}: the zamba2 family does not split its products over a model axis wider "
        "than 1 (its mamba layers read two B / C groups and its shared blocks are tied)")


def fill_params(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                generator: torch.Generator) -> None:
    """Draws ``params`` **in place** from ``generator`` (on their device):
    truncated normal, std ``1 / sqrt(fan_in)`` for the products, 0.02 for
    the embedding, the mamba layers as the ssm family draws them, norm
    offsets zero."""
    trunc_normal_(params["embed"], generator, 0.02)
    fill_mamba_layers({k.split(".", 1)[1]: v for k, v in params.items()
                       if k.startswith("mamba.")}, generator, cfg.d_model)
    for name, p in params.items():
        if name.startswith(("shared.", "apps.")):
            if name.rsplit(".", 1)[1].startswith("ln"):
                p.zero_()
            else:
                trunc_normal_(p, generator, 1.0 / math.sqrt(p.shape[-2]))
    params["final_ln"].zero_()


def shared_block(
    cfg: ModelConfig, sp: Mapping[str, torch.Tensor], ap: Mapping[str, torch.Tensor],
    h: torch.Tensor, e: torch.Tensor,
    positions: torch.Tensor, attn_impl: str,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_positions: Optional[torch.Tensor] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One application: the shared block ``sp`` over ``concat(h, e)``, the
    application's adapter and ``linear`` (``ap``); returns what is added to
    the next mamba layer's input.  ``kv_cache`` is this application's
    ``(B, Skv, Hkv, Dh)`` pair, **updated in place** at ``positions``."""
    z = cfg.zamba2
    B, S, _ = h.shape
    Dh = cfg.dh
    x = rms_norm(torch.cat([h, e], dim=-1), sp["ln1"], EPS)
    q = (x @ sp["wq"]).reshape(B, S, -1, Dh)
    k = (x @ sp["wk"]).reshape(B, S, -1, Dh)
    v = (x @ sp["wv"]).reshape(B, S, -1, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, sin_cos=rope)
    k = apply_rope(k, positions, cfg.rope_theta, sin_cos=rope)
    k_att, v_att, kv_pos = cache_insert(k, v, positions, kv_cache, cache_positions, cache_index)
    o = attention(q, k_att, v_att, positions, kv_pos, impl=attn_impl, scale=(Dh / 2) ** -0.5)
    x = rms_norm(o.reshape(B, S, -1) @ sp["wo"], sp["ln2"], EPS)
    gate, up = (x @ sp["w_gate_up"] + (x @ ap["lora_a"]) @ ap["lora_b"]).chunk(2, dim=-1)
    y = (ACTIVATIONS[z.activation](gate) * up) @ sp["w_down"]
    return y @ ap["linear"]


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "chunked",
    ssd_impl: str = "chunked",
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (A, B, Skv, Hkv, Dh) x2
    cache_positions: Optional[torch.Tensor] = None,
    ssm_states: Optional[torch.Tensor] = None,   # (L, B, H, P, N)
    conv_states: Optional[torch.Tensor] = None,  # (L, B, D_CONV-1, conv_dim)
    decode: bool = False,
    check_room: bool = True,
) -> Tuple[torch.Tensor, State]:
    """Returns (final hidden states after the final norm, ``{"kv", "ssm",
    "conv"}``).  The caches and states passed in are updated **in place**
    and handed back (a prefill passes zeroed ones); without ``ssm_states``
    none is kept.  A KV insert past the cache's end raises ``ValueError``
    unless ``check_room`` is False (the caller checked on the host; the
    insert then clamps)."""
    z = cfg.zamba2
    B, S = tokens.shape
    e = embed(params["embed"], tokens).to(cfg.dtype)
    if positions is None:
        positions = arange_positions(B, S, tokens.device)
    if kv_caches is not None and check_room:
        check_cache_room(positions, S, kv_caches[0].shape[2])
    # the same for every application: computed once
    rope = rope_sin_cos(positions, cfg.dh, cfg.rope_theta)
    cache_index = None if kv_caches is None else _cache_index(positions, kv_caches[0].shape[2])
    app_of = {layer: j for j, layer in enumerate(z.hybrid_layer_ids)}
    # each group's views once, however many applications read it
    shared, apps, mamba = (layer_views(params[g]) for g in ("shared", "apps", "mamba"))

    def shared_add(i: int, h: torch.Tensor) -> Optional[torch.Tensor]:
        """What the application before layer ``i`` (if one is) adds to its input."""
        j = app_of.get(i)
        if j is None:
            return None
        cache = None if kv_caches is None else (kv_caches[0][j], kv_caches[1][j])
        return shared_block(cfg, shared[j % z.mem_blocks], apps[j], h, e, positions, attn_impl,
                            kv_cache=cache, cache_positions=cache_positions, rope=rope,
                            cache_index=cache_index)

    h = run_stack(cfg, mamba, e, range(cfg.n_layers), ssm_states, conv_states, decode, ssd_impl,
                  eps=EPS, pre_add=shared_add)
    h = rms_norm(h, params["final_ln"], EPS)
    return h, {"kv": kv_caches, "ssm": ssm_states, "conv": conv_states}


def train_loss(cfg, params, batch, *, attn_impl, ssd_impl, remat, tp) -> torch.Tensor:
    raise NotImplementedError(
        f"{cfg.name}: the zamba2 family serves only; training waits for a backward of "
        "the SSD kernel (ROADMAP E3)")


def new_state(cfg, batch: int, max_len: int, device, tp: ModelAxis = WHOLE) -> State:
    """The hybrid's state (:func:`repro_torch.models.hybrid.new_state`), a cache an application."""
    return hybrid.new_state(cfg, batch, max_len, device, tp, apps=applications(cfg))


def prefill(cfg, params, batch, max_len, device, state, *, attn_impl, ssd_impl, tp, check_room):
    state = state or new_state(cfg, batch["tokens"].shape[0], max_len, device, tp)
    return forward(cfg, params, batch["tokens"], attn_impl=attn_impl, ssd_impl=ssd_impl,
                   kv_caches=state["kv"], cache_positions=slot_positions(state["kv"][0]),
                   ssm_states=state["ssm"], conv_states=state["conv"], check_room=check_room)


def decode_step(cfg, params, tokens, state, *, attn_impl, ssd_impl, tp, check_room):
    return forward(cfg, params, tokens, positions=state["pos"][:, None], attn_impl=attn_impl,
                   ssd_impl=ssd_impl, kv_caches=state["kv"],
                   cache_positions=slot_positions(state["kv"][0]), ssm_states=state["ssm"],
                   conv_states=state["conv"], decode=True, check_room=check_room)

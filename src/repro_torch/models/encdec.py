"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Counterpart of ``repro.models.encdec``.  The audio frontend is a stub: the
caller gives precomputed frame embeddings (the output of the two-conv mel
frontend), so the encoder is the transformer stack over frames; the decoder
is a causal transformer with cross-attention into the encoder output.

What the reference computes, and the port with it:

* RMSNorm and SwiGLU in both stacks (Whisper's LayerNorm and GELU are not
  used), and no positional encoding in either stack;
* the encoder is bidirectional and so is cross-attention: every query is
  given position ``T`` (the number of frames), which sees every key;
* a decode step recomputes cross-attention's keys and values from the
  encoder output in every layer (no cache of them).

Parameters are layer-stacked under the reference's keys: ``frame_proj``,
``enc.{ln1,wq,wk,wv,wo,ln2,w_gate,w_up,w_down}``, ``enc_ln``, ``embed``,
``dec.*`` (the same plus cross-attention's ``lnx, xq, xk, xv, xo``) and
``final_ln``.  Where the reference scans a stack, the port loops over its
leading axis.

The reference pins a decode step's self-attention to ``"chunked"``; here
``attn_impl="hopper"`` puts the CUDA kernel on all three attentions
(encoder, decoder self-attention at every step, cross-attention), and the
plain paths keep the reference's choice (:func:`decode_self_impl`).

On a mesh whose ``model`` axis is wider than 1 (:func:`split_products`) a
rank computes its whole heads of the encoder's and the decoder's self- and
cross-attention where ``n_heads`` divides the axis (a decode step's cross
keys and values too, and its caches hold those heads), its part of every
SwiGLU MLP over ``ff``, and its rows of the tied vocabulary; ``frame_proj``
stays whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..sharding import WHOLE, ModelAxis, Product
from . import transformer
from .attention import attention
from .common import layer_views, remat_call, rms_norm, swiglu, trunc_normal_
from .hybrid import lm_head_loss
from .transformer import (
    ModelConfig, _cache_index, arange_positions, cache_insert, check_cache_room, embed,
    slot_positions,
)

Params = Dict[str, Any]
KV = Tuple[torch.Tensor, torch.Tensor]

#: the decode state's leaves besides ``pos``
STATE = ("kv", "enc")
#: the head is the embedding's transpose, as the reference's whisper ties it
TIED_HEAD = True
#: no leaf is kept in float32 whatever ``cfg.dtype``
FLOAT32_LEAVES = ()

#: the leaves of one encoder layer, in the reference's order; a decoder
#: layer adds cross-attention's five after ``wo``
_SELF = ("ln1", "wq", "wk", "wv", "wo")
_FFN = ("ln2", "w_gate", "w_up", "w_down")
_CROSS = ("lnx", "xq", "xk", "xv", "xo")


def _layer_shapes(cfg: ModelConfig, names) -> Dict[str, Tuple[int, ...]]:
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    table = {
        "ln1": (L, D), "wq": (L, D, q), "wk": (L, D, kv), "wv": (L, D, kv), "wo": (L, q, D),
        "lnx": (L, D), "xq": (L, D, q), "xk": (L, D, kv), "xv": (L, D, kv), "xo": (L, q, D),
        "ln2": (L, D), "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D),
    }
    return {n: table[n] for n in names}


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``name -> shape`` in the reference's order (dots separate the
    levels of its tree)."""
    D = cfg.d_model
    shapes: Dict[str, Tuple[int, ...]] = {"frame_proj": (D, D)}
    shapes.update({f"enc.{k}": s for k, s in _layer_shapes(cfg, _SELF + _FFN).items()})
    shapes["enc_ln"] = (D,)
    shapes["embed"] = (cfg.vocab, D)
    shapes.update({f"dec.{k}": s for k, s in _layer_shapes(cfg, _SELF + _CROSS + _FFN).items()})
    shapes["final_ln"] = (D,)
    return shapes


#: logical axes of a stacked encoder / decoder leaf, the reference's
_LAYER_AXES = {
    "ln1": ("layers", "embed"), "wq": ("layers", "embed", "heads"),
    "wk": ("layers", "embed", "heads"), "wv": ("layers", "embed", "heads"),
    "wo": ("layers", "heads", "embed"), "ln2": ("layers", "embed"),
    "w_gate": ("layers", "embed", "ff"), "w_up": ("layers", "embed", "ff"),
    "w_down": ("layers", "ff", "embed"),
    "lnx": ("layers", "embed"), "xq": ("layers", "embed", "heads"),
    "xk": ("layers", "embed", "heads"), "xv": ("layers", "embed", "heads"),
    "xo": ("layers", "heads", "embed"),
}
_TOP_AXES = {"frame_proj": ("embed", "embed2"), "enc_ln": ("embed",),
             "embed": ("vocab", "embed_tbl"), "final_ln": ("embed",)}


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys), the reference's."""
    return {name: _LAYER_AXES[name.split(".", 1)[1]] if "." in name else _TOP_AXES[name]
            for name in param_shapes(cfg)}


def split_products(cfg: ModelConfig) -> Dict[str, Product]:
    """The products the ``model`` axis splits, in both stacks alike: the
    query heads of self- and cross-attention (``wq`` / ``xq`` by columns,
    ``wo`` / ``xo`` by rows) and the K / V heads their groups read; the
    SwiGLU MLPs over ``ff``; the tied vocabulary's rows."""
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    stacks = ("enc", "dec")
    q = {f"{s}.{n}": d for s in stacks for n, d in (("wq", 2), ("wo", 1))}
    q.update({"dec.xq": 2, "dec.xo": 1})
    kv = {f"{s}.{n}": 2 for s in stacks for n in ("wk", "wv")}
    kv.update({"dec.xk": 2, "dec.xv": 2})
    ff = {f"{s}.{n}": d for s in stacks for n, d in (("w_gate", 2), ("w_up", 2), ("w_down", 1))}
    return {
        "heads": Product(q, Hq, Dh),
        "kv_heads": Product(kv, Hkv, Dh, read_by=("heads", Hq // Hkv)),
        "ff": Product(ff, cfg.d_ff),
        "vocab": Product({"embed": 0}, cfg.vocab),
    }


def fill_params(
    cfg: ModelConfig, params: Dict[str, torch.Tensor], generator: torch.Generator
) -> None:
    """Draws ``params`` (:func:`param_shapes`' names) **in place** from
    ``generator``, which lives on their device, as the reference draws them:
    truncated normal with std ``1/sqrt(fan_in)`` for every matrix (0.02 for
    ``embed``), zeros for the norms."""
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln") or leaf in ("enc_ln", "final_ln"):
            p.zero_()
        else:
            trunc_normal_(p, generator, 0.02 if leaf == "embed" else 1.0 / math.sqrt(p.shape[-2]))


def decode_self_impl(attn_impl: str) -> str:
    """The attention path of a decode step's self-attention: the kernel where
    asked for, else ``"chunked"`` as the reference pins it."""
    return attn_impl if attn_impl == "hopper" else "chunked"


def _self_block(
    cfg: ModelConfig,
    lp: Dict[str, torch.Tensor],
    h: torch.Tensor,
    positions: torch.Tensor,
    attn_impl: str,
    causal: bool,
    kv_cache: Optional[KV] = None,
    cache_positions: Optional[torch.Tensor] = None,
    cache_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tp: ModelAxis = WHOLE,
) -> torch.Tensor:
    """Self-attention and the SwiGLU FFN of one layer; returns the new hidden
    states.  ``kv_cache`` is this layer's ``(B, max_len, Hkv, Dh)`` pair and
    is **updated in place** at ``positions[:, 0]`` (the reference returns a
    new pair).  Without ``causal`` every query sees every key.  Under ``tp``
    the attention of a rank's heads (its cache holds their K / V heads) and
    its part of the MLP are summed over the ``model`` axis."""
    B, S, _ = h.shape
    Dh = cfg.dh
    x = tp.enter(rms_norm(h, lp["ln1"]), "heads")
    q = (x @ lp["wq"]).reshape(B, S, -1, Dh)
    k = (x @ lp["wk"]).reshape(B, S, -1, Dh)
    v = (x @ lp["wv"]).reshape(B, S, -1, Dh)
    k, v, kv_pos = cache_insert(k, v, positions, kv_cache, cache_positions, cache_index)
    q_pos = positions if causal else torch.full_like(positions, kv_pos.shape[1])
    o = attention(q, k, v, q_pos, kv_pos, impl=attn_impl)
    h = h + tp.leave(o.reshape(B, S, -1) @ lp["wo"], "heads").to(h.dtype)
    x = tp.enter(rms_norm(h, lp["ln2"]), "ff")
    y = tp.leave(swiglu(x @ lp["w_gate"], x @ lp["w_up"]) @ lp["w_down"], "ff")
    return h + y.to(h.dtype)


def _cross(
    cfg: ModelConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor, enc_out: torch.Tensor,
    enc_pos: torch.Tensor, attn_impl: str, tp: ModelAxis = WHOLE,
) -> torch.Tensor:
    """Cross-attention into the encoder output, its keys and values computed
    here (as the reference does at every call); every query sees every
    frame.  Under ``tp`` a rank's heads: the encoder output enters the split
    region with the queries' input."""
    B, S, _ = h.shape
    T = enc_out.shape[1]
    Dh = cfg.dh
    x, enc = tp.enter(rms_norm(h, lp["lnx"]), "heads"), tp.enter(enc_out, "heads")
    q = (x @ lp["xq"]).reshape(B, S, -1, Dh)
    k = (enc @ lp["xk"]).reshape(B, T, -1, Dh)
    v = (enc @ lp["xv"]).reshape(B, T, -1, Dh)
    q_pos = torch.full((B, S), T, dtype=torch.int32, device=h.device)
    o = attention(q, k, v, q_pos, enc_pos, impl=attn_impl)
    return h + tp.leave(o.reshape(B, S, -1) @ lp["xo"], "heads").to(h.dtype)


def encode(
    cfg: ModelConfig, params: Params, frame_embeds: torch.Tensor, attn_impl: str = "chunked",
    tp: ModelAxis = WHOLE,
) -> torch.Tensor:
    """``frame_embeds (B, T, D)`` (the frontend stub's output) -> the encoder
    output ``(B, T, D)`` in ``cfg.dtype``; ``tp`` the plan of a rank's share."""
    h = (frame_embeds.to(cfg.dtype) @ params["frame_proj"]).to(cfg.dtype)
    B, T, _ = h.shape
    positions = arange_positions(B, T, h.device)
    layers = layer_views(params["enc"])
    for i in range(cfg.n_layers):
        h = _self_block(cfg, layers[i], h, positions, attn_impl, causal=False, tp=tp)
    return rms_norm(h, params["enc_ln"])


def decode_train(
    cfg: ModelConfig, params: Params, enc_out: torch.Tensor, tokens: torch.Tensor,
    attn_impl: str = "chunked", remat: str = "none", tp: ModelAxis = WHOLE,
) -> torch.Tensor:
    """Teacher-forced decoder pass over ``tokens (B, S)``; returns the final
    hidden states.  ``remat`` ``dots`` / ``full`` recompute each layer in
    backward (the reference checkpoints its decoder's scan body)."""
    B, S = tokens.shape
    h = embed(params["embed"], tokens, tp).to(cfg.dtype)
    positions = arange_positions(B, S, h.device)
    enc_pos = arange_positions(B, enc_out.shape[1], h.device)

    def body(h, lp):
        h = _self_block(cfg, lp, h, positions, attn_impl, causal=True, tp=tp)
        return _cross(cfg, lp, h, enc_out, enc_pos, attn_impl, tp)

    layers = layer_views(params["dec"])
    for i in range(cfg.n_layers):
        h = remat_call(body, remat, h, layers[i])
    return rms_norm(h, params["final_ln"])


def train_loss(cfg, params, batch, *, attn_impl, ssd_impl, remat, tp) -> torch.Tensor:
    enc = encode(cfg, params, batch["frame_embeds"], attn_impl, tp)
    h = decode_train(cfg, params, enc, batch["tokens"], attn_impl, remat, tp)
    return lm_head_loss(cfg, params, h, batch["targets"], tp=tp)


def new_state(cfg, batch: int, max_len: int, device, tp: ModelAxis = WHOLE):
    """Zeroed self-attention caches in ``cfg.dtype``."""
    return transformer.new_state(cfg, batch, max_len, device, tp, dtype=cfg.dtype)


def prefill(cfg, params, batch, max_len, device, state, *, attn_impl, ssd_impl, tp, check_room):
    """The **encoder output** of ``batch["frame_embeds"]`` and the state ``{"kv", "enc",
    "pos"}``: empty caches (made after the encoder ran), the encoder output and
    position 0 in every row.  The tokens give only the batch size, as in the reference."""
    enc = encode(cfg, params, batch["frame_embeds"], attn_impl, tp)
    B = batch["tokens"].shape[0]
    kv = (state or new_state(cfg, B, max_len, device, tp))["kv"]
    return enc, {"kv": kv, "enc": enc, "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


def decode_step(cfg, params, tokens, state, *, attn_impl, ssd_impl, tp, check_room):
    """Decoder step of ``tokens (B, S)`` at ``state["pos"]`` against the
    self-attention caches ``(L, B, max_len, Hkv, Dh)`` of ``state``, which
    are written **in place** and handed back with the encoder output.  An
    insert past the caches' end raises ``ValueError`` whatever
    ``check_room`` says (the reference clamps it).  Under ``tp`` the caches
    hold a rank's K / V heads."""
    kv_caches, enc_out = state["kv"], state["enc"]
    B, S = tokens.shape
    positions = state["pos"][:, None]
    cache_positions = slot_positions(kv_caches[0])
    check_cache_room(positions, S, kv_caches[0].shape[2])
    h = embed(params["embed"], tokens, tp).to(cfg.dtype)
    enc_pos = arange_positions(B, enc_out.shape[1], h.device)
    cache_index = _cache_index(positions, kv_caches[0].shape[2])
    self_impl = decode_self_impl(attn_impl)
    layers = layer_views(params["dec"])
    for i in range(cfg.n_layers):
        lp = layers[i]
        h = _self_block(cfg, lp, h, positions, self_impl, causal=True,
                        kv_cache=(kv_caches[0][i], kv_caches[1][i]),
                        cache_positions=cache_positions, cache_index=cache_index, tp=tp)
        h = _cross(cfg, lp, h, enc_out, enc_pos, attn_impl, tp)
    return rms_norm(h, params["final_ln"]), {"kv": kv_caches, "enc": enc_out}

"""Decoder-only transformer: the dense, MoE and VLM-backbone families.

Counterpart of ``repro.models.transformer`` for stablelm-3b, qwen2-7b,
granite-8b, gemma3-1b, qwen2-moe-a2.7b, llama4-scout and the qwen2-vl-2b
backbone:

* grouped-query attention with optional QKV bias, per-layer sliding-window /
  chunked masks (gemma3 5:1 local:global, llama4 iRoPE), per-layer RoPE
  theta or none (llama4's global layers), M-RoPE for the VLM;
* dense SwiGLU or a mixture of experts (:func:`moe_ffn`: shared + routed
  experts, top-k by a stable sort, capacity-based scatter dispatch; the
  exact every-expert path for decode-sized inputs);
* parameters are **layer-stacked** under the reference's key names (``embed``,
  ``layers.{ln1,ln2,wq,wk,wv,wo,bq,bk,bv,w_gate,w_up,w_down}`` or the MoE's
  ``layers.{router,we_*,ws_*}``, ``final_ln``, ``lm_head``, ``patch_proj``),
  so a reference checkpoint loads key for key; where the reference scans the
  stack, :func:`forward` loops over its leading axis;
* the same functions serve a full forward pass, prefill (fills a KV cache),
  decode (one token against the cache) and training (``remat`` recomputes
  each layer in backward; :func:`lm_loss` is the chunked cross-entropy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from .attention import attention
from .common import (
    apply_mrope, apply_rope, check_remat, layer_params, mrope_sin_cos, remat_call, rms_norm,
    rope_sin_cos, swiglu, trunc_normal_,
)

Params = Dict[str, Any]

#: sentinel "no restriction" for the per-layer window / chunk values
BIG = 1 << 30


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    shared_gate: bool = False
    capacity_factor: float = 1.25
    norm_topk: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # attention pattern: period p means layer i is GLOBAL iff (i+1) % p == 0;
    # other layers use `window` (sliding) or `attn_chunk` (chunked)
    global_period: int = 1           # 1 => every layer global
    window: Optional[int] = None
    attn_chunk: Optional[int] = None
    nope_on_global: bool = False     # llama4 iRoPE: no RoPE on global layers
    local_rope_theta: Optional[float] = None  # gemma3: 10k local / 1M global
    moe: Optional[MoEConfig] = None
    mrope: bool = False              # qwen2-vl M-RoPE
    # ssm / hybrid knobs are carried here as in the reference
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    attn_period: int = 0
    dtype: torch.dtype = torch.bfloat16
    notes: str = ""

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kinds(self) -> Tuple[int, ...]:
        """0 = local/chunked layer, 1 = global layer."""
        if self.global_period <= 1:
            return (1,) * self.n_layers
        return tuple(int((i + 1) % self.global_period == 0) for i in range(self.n_layers))


# ---------------------------------------------------------------------------
# Parameter shapes + init
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``name -> shape`` of the layer-stacked parameters (dots separate
    the levels of the reference's tree), in the reference's order."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    Hq, Hkv, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_ff
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed": (V, D),
        "layers.ln1": (L, D),
        "layers.ln2": (L, D),
        "layers.wq": (L, D, Hq * Dh),
        "layers.wk": (L, D, Hkv * Dh),
        "layers.wv": (L, D, Hkv * Dh),
        "layers.wo": (L, Hq * Dh, D),
    }
    if cfg.qkv_bias:
        shapes.update({
            "layers.bq": (L, Hq * Dh), "layers.bk": (L, Hkv * Dh), "layers.bv": (L, Hkv * Dh),
        })
    m = cfg.moe
    if m is None:
        shapes.update({"layers.w_gate": (L, D, F), "layers.w_up": (L, D, F),
                       "layers.w_down": (L, F, D)})
    else:
        E, Fe = m.n_experts, m.d_ff_expert
        shapes.update({"layers.router": (L, D, E), "layers.we_gate": (L, E, D, Fe),
                       "layers.we_up": (L, E, D, Fe), "layers.we_down": (L, E, Fe, D)})
        if m.n_shared:
            Fs = m.d_ff_shared
            shapes.update({"layers.ws_gate": (L, D, Fs), "layers.ws_up": (L, D, Fs),
                           "layers.ws_down": (L, Fs, D)})
            if m.shared_gate:
                shapes["layers.ws_g"] = (L, D, 1)
    shapes["final_ln"] = (D,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    if cfg.family == "vlm":
        shapes["patch_proj"] = (D, D)
    return shapes


#: logical axes of each stacked layer leaf, the reference's
_LAYER_AXES = {
    "ln1": ("layers", "embed"), "ln2": ("layers", "embed"),
    "wq": ("layers", "embed", "heads"), "wk": ("layers", "embed", "heads"),
    "wv": ("layers", "embed", "heads"), "wo": ("layers", "heads", "embed"),
    "bq": ("layers", "heads"), "bk": ("layers", "heads"), "bv": ("layers", "heads"),
    "w_gate": ("layers", "embed", "ff"), "w_up": ("layers", "embed", "ff"),
    "w_down": ("layers", "ff", "embed"),
    "router": ("layers", "embed", "expert_dim"),
    "we_gate": ("layers", "expert", "embed", "ff_expert"),
    "we_up": ("layers", "expert", "embed", "ff_expert"),
    "we_down": ("layers", "expert", "ff_expert", "embed"),
    "ws_gate": ("layers", "embed", "ff"), "ws_up": ("layers", "embed", "ff"),
    "ws_down": ("layers", "ff", "embed"), "ws_g": ("layers", "embed", None),
}
#: the vocabulary matrices keep their D dim replicated ("embed_tbl"): the
#: reference's reason is that FSDP-sharding it makes the head contract over a
#: data-sharded dim
_TOP_AXES = {"embed": ("vocab", "embed_tbl"), "final_ln": ("embed",),
             "lm_head": ("embed_tbl", "vocab"), "patch_proj": ("embed", "embed2")}


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys), the
    reference's: the names :mod:`repro_torch.sharding`'s rules map onto a mesh."""
    return {name: _LAYER_AXES[name.split(".", 1)[1]] if "." in name else _TOP_AXES[name]
            for name in param_shapes(cfg)}


def fill_params(
    cfg: ModelConfig, params: Dict[str, torch.Tensor], generator: torch.Generator
) -> None:
    """Draws ``params`` (:func:`param_shapes`' names) **in place** from
    ``generator``, which lives on their device: truncated normal with std
    ``1/sqrt(fan_in)`` for every matrix (0.02 for ``embed``), zeros for norms
    and biases.  A large leaf is drawn block by block into its own storage
    (:func:`repro_torch.models.common.trunc_normal_`), so no second copy of
    the weights is made."""
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("ln", "b")) or leaf == "final_ln":
            p.zero_()
        else:
            std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(p.shape[-2])
            trunc_normal_(p, generator, std)


def nest(flat: Dict[str, torch.Tensor]) -> Params:
    """``{"layers.wq": t}`` -> ``{"layers": {"wq": t}}``: the tree the
    functions below (and the reference) index."""
    tree: Params = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


# ---------------------------------------------------------------------------
# Mixture of experts (capacity-based scatter; the exact path for small T)
# ---------------------------------------------------------------------------

#: the reference's threshold: inputs of at most this many tokens (decode, short
#: prompts) take the exact path, longer ones the capacity path
DENSE_PATH_MAX_TOKENS = 256


def route(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], m: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router: ``(gate, expert)``, each ``(T, top_k)``, of ``x (T, D)``.

    Softmax of the fp32 router logits, then the ``top_k`` largest by a
    **stable** descending sort, so that among equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
    leaves ties in no stated order, and the capacity path drops tokens by
    this order).  With ``norm_topk`` the gates are divided by their sum
    (floored at 1e-9)."""
    probs = torch.softmax((x @ lp["router"]).float(), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :m.top_k], expert[:, :m.top_k]
    if m.norm_topk:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gate, expert


def _moe_dense_exact(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], m: MoEConfig,
    gate: torch.Tensor, expert: torch.Tensor,
) -> torch.Tensor:
    """Exact no-drop MoE for small ``T``: every expert runs on every token and
    the top-k weights select.  ``O(T·E·D·F)``: decode-sized inputs only.  The
    products are batched over the experts against the stacked weights as they
    lie (no copy of a weight)."""
    h = swiglu(torch.matmul(x, lp["we_gate"]), torch.matmul(x, lp["we_up"]))   # (E, T, F)
    y_all = torch.bmm(h, lp["we_down"])                                      # (E, T, D)
    onehot = torch.nn.functional.one_hot(expert, m.n_experts).to(y_all.dtype)  # (T, k, E)
    w = (onehot * gate[..., None].to(y_all.dtype)).sum(dim=1)                 # (T, E)
    return torch.einsum("etd,te->td", y_all, w)


def moe_ffn(
    x: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    m: MoEConfig,
    dense_path_max_tokens: int = DENSE_PATH_MAX_TOKENS,
) -> torch.Tensor:
    """``x (T, D) -> (T, D)``.  Sort-based position assignment and a scatter
    into an ``(E, C, D)`` expert buffer; an assignment past an expert's
    capacity ``C`` goes to a drop bucket and contributes 0.  Inputs of at most
    ``dense_path_max_tokens`` tokens take the exact path.  The shapes depend
    on ``T`` alone, so nothing here reads a value back to the host."""
    T, D = x.shape
    E, k = m.n_experts, m.top_k
    C = max(1, int(math.ceil(T * k / E * m.capacity_factor)))
    gate, expert = route(x, lp, m)

    if T <= dense_path_max_tokens:
        y = _moe_dense_exact(x, lp, m, gate, expert)
    else:
        flat_e = expert.reshape(-1)                                   # (T*k,)
        # position of each assignment within its expert, via a stable sort
        perm = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[perm]
        idx = torch.arange(T * k, device=x.device)
        is_start = torch.ones_like(sorted_e, dtype=torch.bool)
        is_start[1:] = sorted_e[1:] != sorted_e[:-1]
        group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
        pos = (idx - group_start)[torch.argsort(perm, stable=True)]
        keep = pos < C
        dest = torch.where(keep, flat_e * C + pos, E * C)             # drop bucket at E*C
        # each kept assignment has a slot of its own; only the drop bucket,
        # which is cut off below, receives more than one
        buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
        buf.index_add_(0, dest, x.repeat_interleave(k, dim=0))
        xe = buf[:E * C].view(E, C, D)
        h = swiglu(torch.bmm(xe, lp["we_gate"]), torch.bmm(xe, lp["we_up"]))
        ye = torch.cat([torch.bmm(h, lp["we_down"]).reshape(E * C, D),
                        torch.zeros((1, D), dtype=x.dtype, device=x.device)])
        y = ye[dest] * gate.reshape(-1, 1).to(ye.dtype) * keep[:, None]
        y = y.reshape(T, k, D).sum(dim=1)

    if m.n_shared:
        ys = swiglu(x @ lp["ws_gate"], x @ lp["ws_up"]) @ lp["ws_down"]
        if m.shared_gate:
            # the gate's sigmoid in fp32, rounded to the model's dtype before the product
            ys = ys * torch.sigmoid((x @ lp["ws_g"]).float()).to(ys.dtype)
        y = y + ys
    return y


# ---------------------------------------------------------------------------
# Transformer block + step functions
# ---------------------------------------------------------------------------


def _qkv(
    h: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (
        q.reshape(B, S, Hq, Dh),
        k.reshape(B, S, Hkv, Dh),
        v.reshape(B, S, Hkv, Dh),
    )


RopeTables = Dict[Any, Tuple[torch.Tensor, torch.Tensor]]


def _rope_tables(
    cfg: ModelConfig, positions: torch.Tensor, mrope_positions: Optional[torch.Tensor] = None
) -> RopeTables:
    """sin / cos for each theta the layers use, once per forward pass; under
    M-RoPE (``cfg.mrope`` and ``(B, S, 3)`` positions given) the one table
    every layer uses, under the key ``"mrope"``."""
    if cfg.mrope and mrope_positions is not None:
        return {"mrope": mrope_sin_cos(mrope_positions, cfg.dh, cfg.rope_theta)}
    thetas = {cfg.rope_theta}
    if cfg.local_rope_theta is not None:
        thetas.add(cfg.local_rope_theta)
    return {theta: rope_sin_cos(positions, cfg.dh, theta) for theta in thetas}


def _rope(
    cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, kind: int,
    tables: Optional[RopeTables] = None, mrope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``kind`` is a Python int here (the reference traces it and selects).
    M-RoPE, where it applies, goes before the local-theta and NoPE rules."""
    tables = tables or {}
    if cfg.mrope and mrope_positions is not None:
        return apply_mrope(x, mrope_positions, cfg.rope_theta, sin_cos=tables.get("mrope"))
    theta = cfg.rope_theta
    if cfg.local_rope_theta is not None:
        if kind == 0:
            theta = cfg.local_rope_theta  # gemma3: local layers use the local theta
    elif cfg.nope_on_global and kind > 0:
        return x                          # llama4: no RoPE on global layers
    return apply_rope(x, positions, theta, sin_cos=tables.get(theta))


def _mask_params(cfg: ModelConfig, kind: int) -> Tuple[int, int]:
    """Per-layer (window, chunk) as integers (BIG = unrestricted)."""
    if kind > 0:
        return BIG, BIG
    return cfg.window or BIG, cfg.attn_chunk or BIG


def block(
    cfg: ModelConfig,
    h: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    kind: int,
    positions: torch.Tensor,
    attn_impl: str,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_positions: Optional[torch.Tensor] = None,
    rope_tables: Optional[RopeTables] = None,
    cache_index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mrope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One pre-norm transformer block; returns the new hidden states.

    ``kv_cache`` is this layer's ``(B, Skv, Hkv, Dh)`` pair and is **updated
    in place** with the current keys and values at ``positions[:, 0]``,
    rounded to the cache's dtype (the reference returns a new pair instead).
    ``rope_tables`` and ``cache_index`` are what :func:`forward` computes once
    for all layers; a lone call works them out itself.
    """
    x = rms_norm(h, lp["ln1"])
    q, k, v = _qkv(x, lp, cfg)
    q = _rope(cfg, q, positions, kind, rope_tables, mrope_positions)
    k = _rope(cfg, k, positions, kind, rope_tables, mrope_positions)

    if kv_cache is not None:
        ck, cv = kv_cache
        rows, cols = cache_index if cache_index is not None else _cache_index(positions)
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
        k_att, v_att = ck, cv
        kv_positions = cache_positions
    else:
        k_att, v_att = k, v
        kv_positions = positions

    window, chunk = _mask_params(cfg, kind)
    o = attention(
        q, k_att, v_att, positions, kv_positions,
        impl=attn_impl, window=window, chunk_attn=chunk,
    )
    B, S = h.shape[:2]
    h = h + (o.reshape(B, S, -1) @ lp["wo"]).to(h.dtype)

    x = rms_norm(h, lp["ln2"])
    if cfg.moe is None:
        y = swiglu(x @ lp["w_gate"], x @ lp["w_up"]) @ lp["w_down"]
    else:
        y = moe_ffn(x.reshape(-1, cfg.d_model), lp, cfg.moe).reshape(x.shape)
    return h + y.to(h.dtype)


def _cache_index(positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index tensors of the cache rows that ``S`` tokens starting at
    ``positions[:, 0]`` fill: ``(B, 1)`` batch rows and ``(B, S)`` columns."""
    B, S = positions.shape
    rows = torch.arange(B, device=positions.device)[:, None]
    cols = positions[:, :1].long() + torch.arange(S, device=positions.device)[None]
    return rows, cols


def check_cache_room(positions: torch.Tensor, S: int, max_len: int) -> None:
    """Raises ``ValueError`` unless ``S`` tokens starting at every
    ``positions[:, 0]`` fit a cache of ``max_len`` (the reference's
    ``dynamic_update_slice`` would clamp the start and overwrite the tail).
    One host read a call; none on ``meta`` tensors, which hold no values (the
    dry-run's)."""
    if positions.device.type == "meta":
        return
    first, last = torch.stack(torch.aminmax(positions[:, 0])).tolist()
    if first < 0 or last + S > max_len:
        raise ValueError(
            f"KV cache of length {max_len} cannot take {S} token(s) starting at "
            f"positions {first}..{last}"
        )


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) integer
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "chunked",
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L,B,Skv,Hkv,Dh) x2
    cache_positions: Optional[torch.Tensor] = None,
    patch_embeds: Optional[torch.Tensor] = None,     # (B, P, D): vlm only
    mrope_positions: Optional[torch.Tensor] = None,  # (B, S, 3): vlm only
    remat: str = "none",                             # none | dots | full
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (final hidden states (B,S,D), the KV caches or None).

    For the vlm family, ``patch_embeds`` (precomputed by the vision frontend,
    a stub as in the reference) are projected by ``patch_proj`` and replace
    the first ``P`` token embeddings; ``mrope_positions`` give every layer
    M-RoPE in place of RoPE.

    The caches are written **in place** and handed back for the reference's
    calling convention.  The reference's insert clamps a write that would run
    past the cache's end (``dynamic_update_slice``); this raises ``ValueError``
    instead.

    ``remat`` ``dots`` / ``full`` recompute each block in backward
    (:func:`repro_torch.models.common.remat_call`).  The embedding is looked
    up by ``F.embedding``, whose backward on CUDA is deterministic (an
    indexing's would add rows with atomics).
    """
    check_remat(remat)
    B, S = tokens.shape
    h = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    if cfg.family == "vlm" and patch_embeds is not None:
        P = patch_embeds.shape[1]
        proj = (patch_embeds.to(cfg.dtype) @ params["patch_proj"]).to(cfg.dtype)
        h = torch.cat([proj, h[:, P:]], dim=1)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    if kv_caches is not None:
        check_cache_room(positions, S, kv_caches[0].shape[2])

    # the same for every layer: computed once
    rope_tables = _rope_tables(cfg, positions, mrope_positions)
    cache_index = None if kv_caches is None else _cache_index(positions)

    layers = params["layers"]
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = layer_params(layers, i)
        cache = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        h = remat_call(block, remat, cfg, h, lp, kind, positions, attn_impl,
                       kv_cache=cache, cache_positions=cache_positions,
                       rope_tables=rope_tables, cache_index=cache_index,
                       mrope_positions=mrope_positions)

    h = rms_norm(h, params["final_ln"])
    return h, kv_caches


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _chunk_nll(cfg: ModelConfig, params: Params, h: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk: fp32 logits of
    ``h (B, c, D)``, targets ``< 0`` left out."""
    logits = lm_head(cfg, params, h).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                           ignore_index=-1, reduction="sum")


def lm_loss(
    cfg: ModelConfig,
    params: Params,
    h: torch.Tensor,        # (B, S, D) final hidden
    targets: torch.Tensor,  # (B, S) integer; < 0 is not counted
    chunk: int = 512,
) -> torch.Tensor:
    """Chunked cross-entropy: the ``(B, S, V)`` logits are never built.

    The sequence is cut into chunks of ``chunk`` positions; each chunk's
    logits (in fp32) live only inside its step, and the step goes through
    ``torch.utils.checkpoint``: without it, backward would keep every
    chunk's ``(B, c, V)`` logits, which is the whole logits tensor the
    chunking exists to avoid.  Returns the mean over the counted targets
    (the count floored at 1).  ``F.cross_entropy`` gives ``logsumexp - gold``
    as the reference writes it, with a backward that writes each gradient
    once (a gather's backward would add with atomics on CUDA)."""
    B, S, _ = h.shape
    targets = targets.long()
    targets = torch.where(targets >= 0, targets, torch.full_like(targets, -1))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        hh, tt = h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(
                _chunk_nll, cfg, params, hh, tt, use_reentrant=False)
        else:
            total = total + _chunk_nll(cfg, params, hh, tt)
    count = (targets >= 0).sum()
    return total / count.clamp_min(1)


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int,
    dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(L, B, max_len, Hkv, Dh)`` caches — bfloat16 whatever
    ``cfg.dtype`` is, as in the reference: a float32 model still attends over
    bfloat16 keys and values on the cached path."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_axes() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """Logical axes of the ``(L, B, S, Hkv, Dh)`` K and V caches."""
    ax = ("layers", "batch", "kv_seq", "heads", "head_dim")
    return ax, ax

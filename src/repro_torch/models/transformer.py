"""Decoder-only transformer, dense family.

Counterpart of ``repro.models.transformer`` for stablelm-3b, qwen2-7b,
granite-8b and gemma3-1b:

* grouped-query attention with optional QKV bias, per-layer sliding-window /
  chunked masks (gemma3 5:1 local:global), per-layer RoPE theta;
* dense SwiGLU feed-forward;
* parameters are **layer-stacked** under the reference's key names (``embed``,
  ``layers.{ln1,ln2,wq,wk,wv,wo,bq,bk,bv,w_gate,w_up,w_down}``, ``final_ln``,
  ``lm_head``), so a reference checkpoint loads key for key; where the
  reference scans the stack, :func:`forward` loops over its leading axis;
* the same functions serve a full forward pass, prefill (fills a KV cache)
  and decode (one token against the cache).

Mixture-of-experts, the vision prefix / M-RoPE, rematerialisation and the
training loss belong to later slices of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import attention
from .common import apply_rope, rms_norm, rope_sin_cos, swiglu, trunc_normal

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


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts layers (moe_ffn) are not ported yet; "
            "they come with the MoE slice of the port"
        )
    if cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE / patch embeddings are not ported yet; "
            "they come with the VLM slice of the port"
        )


# ---------------------------------------------------------------------------
# Parameter shapes + init
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``name -> shape`` of the layer-stacked parameters (dots separate
    the levels of the reference's tree)."""
    _require_dense(cfg)
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
    shapes.update({
        "layers.w_gate": (L, D, F), "layers.w_up": (L, D, F), "layers.w_down": (L, F, D),
        "final_ln": (D,),
    })
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: DeviceLike = "cuda"
) -> Dict[str, torch.Tensor]:
    """Random parameters as a flat ``name -> tensor`` dict (see
    :func:`param_shapes`): truncated normal with std ``1/sqrt(fan_in)`` for
    the matrices (0.02 for ``embed``), zeros for norms and biases.
    ``generator`` must live on ``device``."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("ln", "b")) or leaf == "final_ln":
            out[name] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        else:
            std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(shape[-2])
            out[name] = trunc_normal(generator, shape, std=std, dtype=cfg.dtype, device=device)
    return out


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


RopeTables = Dict[float, Tuple[torch.Tensor, torch.Tensor]]


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> RopeTables:
    """sin / cos for each theta the layers use, once per forward pass."""
    thetas = {cfg.rope_theta}
    if cfg.local_rope_theta is not None:
        thetas.add(cfg.local_rope_theta)
    return {theta: rope_sin_cos(positions, cfg.dh, theta) for theta in thetas}


def _rope(
    cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, kind: int,
    tables: Optional[RopeTables] = None,
) -> torch.Tensor:
    """``kind`` is a Python int here (the reference traces it and selects)."""
    theta = cfg.rope_theta
    if cfg.local_rope_theta is not None and kind == 0:
        theta = cfg.local_rope_theta      # gemma3: local layers use the local theta
    elif cfg.nope_on_global and kind > 0:
        return x
    return apply_rope(x, positions, theta, sin_cos=tables.get(theta) if tables else None)


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
    q = _rope(cfg, q, positions, kind, rope_tables)
    k = _rope(cfg, k, positions, kind, rope_tables)

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
    y = swiglu(x @ lp["w_gate"], x @ lp["w_up"]) @ lp["w_down"]
    return h + y.to(h.dtype)


def _cache_index(positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index tensors of the cache rows that ``S`` tokens starting at
    ``positions[:, 0]`` fill: ``(B, 1)`` batch rows and ``(B, S)`` columns."""
    B, S = positions.shape
    rows = torch.arange(B, device=positions.device)[:, None]
    cols = positions[:, :1].long() + torch.arange(S, device=positions.device)[None]
    return rows, cols


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) integer
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "chunked",
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L,B,Skv,Hkv,Dh) x2
    cache_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (final hidden states (B,S,D), the KV caches or None).

    The caches are written **in place** and handed back for the reference's
    calling convention.  The reference's insert clamps a write that would run
    past the cache's end (``dynamic_update_slice``); this raises ``ValueError``
    instead.
    """
    _require_dense(cfg)
    B, S = tokens.shape
    h = params["embed"][tokens].to(cfg.dtype)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    if kv_caches is not None:
        max_len = kv_caches[0].shape[2]
        # one host read a call: the bounds of the insert
        first, last = torch.stack(torch.aminmax(positions[:, 0])).tolist()
        if first < 0 or last + S > max_len:
            raise ValueError(
                f"KV cache of length {max_len} cannot take {S} token(s) starting at "
                f"positions {first}..{last}"
            )

    # the same for every layer: computed once
    rope_tables = _rope_tables(cfg, positions)
    cache_index = None if kv_caches is None else _cache_index(positions)

    layers = params["layers"]
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = {name: w[i] for name, w in layers.items()}
        cache = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        h = block(cfg, h, lp, kind, positions, attn_impl,
                  kv_cache=cache, cache_positions=cache_positions,
                  rope_tables=rope_tables, cache_index=cache_index)

    h = rms_norm(h, params["final_ln"])
    return h, kv_caches


def lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


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

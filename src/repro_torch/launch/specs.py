"""Abstract inputs and their placements for every (arch x shape) cell.

Counterpart of ``repro.launch.specs``.  The inputs of each step kind are
``meta`` tensors (shape and dtype, no storage) where the reference builds
``ShapeDtypeStruct`` s; the placements are :class:`repro_torch.sharding.Sharding` s:

* batch dims shard over the data axes (``pod`` x ``data``); a batch of 1
  (long_500k) leaves batch unsharded and puts the model axis on the KV/SSM
  sequence/state dims instead;
* KV caches shard heads over ``model`` when the head count divides the axis,
  else the cache *sequence* is sharded over ``model`` (GQA archs with few
  KV heads);
* SSM states shard their head dim over ``model`` when divisible.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeCell
from ..models import ModelConfig
from ..models import hybrid as hybrid_mod
from ..models.mamba2 import D_CONV, mamba_dims
from ..sharding import DATA_AXES, Sharding, mesh_axes

#: the batch dim of each decode-state leaf
STATE_BATCH_DIM = {"pos": 0, "kv": 1, "ssm": 1, "conv": 1, "enc": 0}


def S(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def data_axes(mesh):
    axes = tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def model_axis_size(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


# ---------------------------------------------------------------------------
# Shape-cell geometry per family
# ---------------------------------------------------------------------------


def cell_geometry(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, int]:
    """Resolve the canonical (seq_len x batch) into per-family input dims."""
    g = {"batch": cell.global_batch, "seq": cell.seq_len, "n_patches": 0, "n_frames": 0}
    if cfg.family == "vlm":
        g["n_patches"] = 256  # fixed-resolution stub: 256 patch tokens prefix
    if cfg.family == "audio":
        g["n_frames"] = 1500  # 30 s of audio
        # the seq budget is split: 1500 encoder frames + decoder positions
        g["seq"] = max(cell.seq_len - 1500, 448 if cell.kind != "train" else 2048)
        if cell.kind == "train":
            g["seq"] = min(g["seq"], 4096)
    return g


# ---------------------------------------------------------------------------
# Abstract inputs per step kind
# ---------------------------------------------------------------------------


def train_inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    g = cell_geometry(cfg, cell)
    B, Sq = g["batch"], g["seq"]
    out = {
        "tokens": S((B, Sq), torch.int32),
        "targets": S((B, Sq), torch.int32),
    }
    if cfg.family == "vlm":
        out["patch_embeds"] = S((B, g["n_patches"], cfg.d_model), torch.bfloat16)
        out["mrope_positions"] = S((B, Sq, 3), torch.int32)
    if cfg.family == "audio":
        out["frame_embeds"] = S((B, g["n_frames"], cfg.d_model), torch.bfloat16)
    return out


def prefill_inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    out = train_inputs(cfg, cell)
    out.pop("targets")
    return out


def decode_state_struct(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Abstract decode state matching Model.prefill's output structure."""
    st: Dict[str, Any] = {"pos": S((batch,), torch.int32)}
    if cfg.family in ("dense", "moe", "vlm"):
        kv = S((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh), torch.bfloat16)
        st["kv"] = (kv, kv)
    elif cfg.family == "ssm":
        d_inner, conv_dim = mamba_dims(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        st["ssm"] = S((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      torch.float32)
        st["conv"] = S((cfg.n_layers, batch, D_CONV - 1, conv_dim), torch.bfloat16)
    elif cfg.family == "hybrid":
        apps = hybrid_mod.n_attn_applications(cfg)
        d_inner, conv_dim = mamba_dims(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        kv = S((apps, batch, max_len, cfg.n_kv_heads, cfg.dh), torch.bfloat16)
        st["kv"] = (kv, kv)
        st["ssm"] = S((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      torch.float32)
        st["conv"] = S((cfg.n_layers, batch, D_CONV - 1, conv_dim), torch.bfloat16)
    elif cfg.family == "audio":
        kv = S((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh), torch.bfloat16)
        st["kv"] = (kv, kv)
        st["enc"] = S((batch, 1500, cfg.d_model), cfg.dtype)
    return st


def decode_inputs(cfg: ModelConfig, cell: ShapeCell) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    g = cell_geometry(cfg, cell)
    B = g["batch"]
    max_len = g["seq"] if cfg.family != "audio" else max(g["seq"], 448)
    # pad the cache length to a multiple of 1024 so a model-axis-sharded
    # sequence dim always divides (e.g. whisper's 31268-token budget)
    max_len = -(-max_len // 1024) * 1024
    tokens = S((B, 1), torch.int32)
    return {"tokens": tokens}, decode_state_struct(cfg, B, max_len)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------


def _dp_for_batch(mesh, batch: int):
    dp = data_axes(mesh)
    if dp is None:
        return None
    sizes = mesh_axes(mesh)
    size = math.prod(sizes[a] for a in (dp if isinstance(dp, tuple) else (dp,)))
    return dp if batch % size == 0 and batch >= size else None


def batch_shardings(mesh, inputs: Dict[str, Any], batch: int) -> Dict[str, Any]:
    dp = _dp_for_batch(mesh, batch)
    return {k: Sharding(mesh, (dp,) + (None,) * (leaf.dim() - 1)) for k, leaf in inputs.items()}


def state_shardings(cfg: ModelConfig, mesh, state: Dict[str, Any], batch: int) -> Dict[str, Any]:
    dp = _dp_for_batch(mesh, batch)
    ms = model_axis_size(mesh)
    heads_shardable = cfg.n_kv_heads > 0 and cfg.n_kv_heads % ms == 0
    ssm_shardable = cfg.ssm_heads > 0 and cfg.ssm_heads % ms == 0
    # batch=1 (long_500k): put every mesh axis on the sequence/state dims
    seq_axes: Any = "model" if dp is not None else tuple(
        a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names
    )

    out: Dict[str, Any] = {}
    for key in state:
        if key == "pos":
            out[key] = Sharding(mesh, (dp,))
        elif key == "kv":
            if heads_shardable:
                spec = (None, dp, None, "model", None)
            else:
                spec = (None, dp, seq_axes, None, None)
            out[key] = (Sharding(mesh, spec), Sharding(mesh, spec))
        elif key == "ssm":
            out[key] = Sharding(mesh, (None, dp, "model" if ssm_shardable else None, None, None))
        elif key == "conv":
            out[key] = Sharding(mesh, (None, dp, None, "model"))
        elif key == "enc":
            out[key] = Sharding(mesh, (dp, None, None))
        else:  # pragma: no cover
            out[key] = Sharding(mesh, ())
    return out

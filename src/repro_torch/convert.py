"""Carrying weights and decode state between the reference and the port.

The reference keeps its parameters as a nested tree of arrays
(``{"embed": ..., "layers": {"wq": ...}, ...}``, layer-stacked); the port's
``Model`` keeps the same tensors under the same names joined by dots.  These
functions translate between the two **as numpy arrays** — the caller converts
the reference's arrays to numpy and back, so this module imports no JAX.

numpy has no bfloat16: such arrays travel as float32, which holds every
bfloat16 value exactly, and are rounded back on arrival — to each leaf's own
dtype (:func:`repro_torch.models.param_dtypes`: a mamba layer's ``a_log``,
``d_skip`` and ``dt_bias`` stay float32 in a bfloat16 model, as in the
reference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import ModelConfig, param_dtypes, param_shapes

Tree = Mapping[str, Any]


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, f"{name}."))
        else:
            flat[name] = np.asarray(value)
    return flat


def _from_numpy(arr, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A tensor that owns its memory (never a view of the caller's array)."""
    return torch.tensor(np.asarray(arr, dtype=np.float32)).to(device=device, dtype=dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_reference(
    tree: Tree, cfg: ModelConfig, device: DeviceLike = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) as a state dict for
    ``Model.load_state_dict`` / ``Server``: key for key, shapes checked
    against ``cfg``, each leaf cast to its dtype in the reference
    (:func:`param_dtypes`).  ``dtype`` overrides the leaves whose dtype is
    ``cfg.dtype``; the float32 leaves stay float32."""
    device = resolve_device(device)
    dtypes = param_dtypes(cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype))
    flat = _flatten(tree)
    shapes = param_shapes(cfg)
    if set(flat) != set(shapes):
        missing, extra = sorted(set(shapes) - set(flat)), sorted(set(flat) - set(shapes))
        raise KeyError(f"parameter tree does not match {cfg.name}: missing {missing}, unexpected {extra}")
    state: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        arr = flat[name]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, {cfg.name} wants {shape}")
        state[name] = _from_numpy(arr, device, dtypes[name])
    return state


def params_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: a state dict as the reference's nested tree of numpy
    arrays (bfloat16 as float32)."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = _to_numpy(t)
    return tree


#: the dtype of each leaf of the decode state, as the reference keeps it
#: (``kv`` is the caller's: bfloat16 for the dense family, ``cfg.dtype`` for the
#: hybrid's; ``conv`` is bfloat16 whatever the model's dtype)
_STATE_DTYPES = {"ssm": torch.float32, "conv": torch.bfloat16}


def state_from_reference(
    state: Tree, device: DeviceLike = "cuda", kv_dtype: torch.dtype = torch.bfloat16
) -> Dict[str, Any]:
    """The reference's decode state (numpy leaves) as the port's: ``kv`` a
    pair of ``(L or apps, B, S, Hkv, Dh)`` arrays in ``kv_dtype``, ``ssm``
    ``(L, B, H, P, N)`` float32, ``conv`` ``(L, B, D_CONV-1, conv_dim)``
    bfloat16, the audio family's encoder output ``enc`` ``(B, T, D)`` in
    ``kv_dtype`` (its caches' and its own dtype are both ``cfg.dtype``), ``pos``
    ``(B,)`` int32; whichever of them the family has."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    if "kv" in state:
        out["kv"] = tuple(_from_numpy(x, device, kv_dtype) for x in state["kv"])
    if "enc" in state:
        out["enc"] = _from_numpy(state["enc"], device, kv_dtype)
    for key, dt in _STATE_DTYPES.items():
        if key in state:
            out[key] = _from_numpy(state[key], device, dt)
    out["pos"] = torch.tensor(np.asarray(state["pos"], dtype=np.int32)).to(device)
    return out


def state_to_reference(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's decode state as numpy leaves (bfloat16 as float32)."""
    out: Dict[str, Any] = {}
    for key, leaf in state.items():
        out[key] = tuple(_to_numpy(x) for x in leaf) if isinstance(leaf, tuple) else _to_numpy(leaf)
    return out

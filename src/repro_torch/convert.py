"""Carrying weights and decode state between the reference and the port.

The reference keeps its parameters as a nested tree of arrays
(``{"embed": ..., "layers": {"wq": ...}, ...}``, layer-stacked); the port's
``Model`` keeps the same tensors under the same names joined by dots.  These
functions translate between the two **as numpy arrays** — the caller converts
the reference's arrays to numpy and back, so this module imports no JAX.

numpy has no bfloat16: such arrays travel as float32, which holds every
bfloat16 value exactly, and are rounded back on arrival.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.transformer import ModelConfig, param_shapes

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
    against ``cfg``, cast to ``dtype`` (``cfg.dtype`` if not given)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
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
        state[name] = _from_numpy(arr, device, dtype)
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


def state_from_reference(
    state: Tree, device: DeviceLike = "cuda", kv_dtype: torch.dtype = torch.bfloat16
) -> Dict[str, Any]:
    """The reference's decode state (``kv``: a pair of ``(L, B, S, Hkv, Dh)``
    arrays, ``pos``: ``(B,)``; numpy leaves) as the port's."""
    device = resolve_device(device)
    kv = tuple(_from_numpy(x, device, kv_dtype) for x in state["kv"])
    pos = torch.tensor(np.asarray(state["pos"], dtype=np.int32)).to(device)
    return {"kv": kv, "pos": pos}


def state_to_reference(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's decode state as numpy leaves (bfloat16 as float32)."""
    return {
        "kv": tuple(_to_numpy(x) for x in state["kv"]),
        "pos": _to_numpy(state["pos"]),
    }

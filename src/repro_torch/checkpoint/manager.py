"""Checkpointing: atomic, async, keep-k.

Counterpart of ``repro.checkpoint.manager``, with the same layout on disk, so
that a checkpoint written by either package restores into the other:

* a tree is a nested dict (or tuple / list) of tensors or arrays; each leaf's
  key is its path joined by ``/`` (dict keys in sorted order, as JAX
  flattens them), its file ``key.replace("/", "__") + ".npy"``;
* ``manifest.json`` holds ``{"leaves": [{"key", "file", "shape", "dtype"}],
  "extra": {...}}``; a bfloat16 leaf is stored as its raw bits (``uint16``)
  with ``"dtype": "bfloat16"``, read back through an ``int16`` view (no
  ``ml_dtypes``);
* **atomicity**: the leaves and the manifest are written to
  ``<path>.tmp``, which is renamed to ``<path>`` only once complete;
* **async**: ``save()`` copies the tensors to host memory, then writes on a
  worker thread; ``wait()`` joins it and raises what it raised;
* **keep-k**: older checkpoints beyond ``keep`` are deleted after a save;
* **sharded leaves**: a DTensor leaf is gathered to its full tensor on every
  rank (a collective, so every rank calls ``save``) and written by the rank
  whose manager is the ``writer`` (rank 0) alone: the layout on disk is the
  one above whatever the mesh;
* **elastic restore**: ``restore(..., shardings=...)`` places each leaf on
  its target :class:`repro_torch.sharding.Sharding`, which may belong to
  another mesh than the one the checkpoint was saved under, or to none.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..sharding import Sharding, distribute

Tree = Any

_SEP = "/"

#: numpy's name of each dtype a leaf may have, and back
_TORCH_TO_NUMPY = {
    torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
    torch.uint8: np.uint8, torch.bool: np.bool_,
}
_NUMPY_TO_TORCH = {np.dtype(v).name: k for k, v in _TORCH_TO_NUMPY.items()}


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the order JAX flattens the same tree."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _rebuild(like: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves, f"{prefix}{_SEP}{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(array to store, dtype name)`` of a leaf, a copy in host memory that
    later updates of the leaf do not touch: bfloat16 as raw bits; a DTensor
    gathered to its full tensor first."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), np.dtype(_TORCH_TO_NUMPY[t.dtype]).name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()   # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype not in _NUMPY_TO_TORCH:
        raise TypeError(f"cannot restore a leaf of dtype {dtype}")
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


def save_tree(path: str, tree: Tree, extra: Optional[Dict[str, Any]] = None) -> None:
    """Synchronous atomic save of a tree of tensors or arrays."""
    _write(path, [(key, _to_host(leaf)) for key, leaf in _flatten(tree)], extra or {})


def restore_tree(
    path: str, like: Tree, shardings: Optional[Tree] = None,
) -> Tuple[Tree, Dict[str, Any]]:
    """The checkpoint at ``path`` in the structure of ``like``: each leaf a
    tensor in the dtype it was saved in.  ``shardings`` (a tree matching
    ``like``, of :class:`~repro_torch.sharding.Sharding` or ``None`` leaves)
    places each leaf on its mesh as a DTensor, whatever mesh the checkpoint
    was written under (elastic restore); without it a DTensor leaf of
    ``like`` keeps its own layout, and any other leaf lands on the device of
    ``like``'s leaf (the CPU where that is not a tensor).  A leaf whose
    (global) shape differs from ``like``'s raises ``ValueError``, a missing
    one ``KeyError``."""
    targets = dict(_flatten(shardings)) if shardings is not None else {}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves: Dict[str, Any] = {}
    for key, leaf in _flatten(like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, entry["file"]))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {tuple(want)}")
        t = _from_host(arr, entry["dtype"])
        target = targets.get(key)
        if target is None and isinstance(leaf, DTensor):
            target = Sharding.of(leaf)
        if target is not None:
            leaves[key] = distribute(t.to(target.device), target)
        else:
            leaves[key] = t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t
    return _rebuild(like, leaves), manifest["extra"]


class CheckpointManager:
    """``writer`` False: ``save`` gathers sharded leaves (the collective every
    rank joins) and writes nothing; the rank-0 manager writes."""

    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree: Tree, extra: Optional[Dict[str, Any]] = None,
             async_: bool = True) -> None:
        self.wait()
        # snapshot to host memory before returning control to training
        host = [(key, _to_host(leaf)) for key, leaf in _flatten(tree)]
        if not self.writer:
            return
        extra = dict(extra or {}, step=step)
        path = self._path(step)

        def work():
            try:
                _write(path, host, extra)
                self._gc()
            except BaseException as e:  # surfaced in wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    # -- restore -----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(
        self, like: Tree, step: Optional[int] = None, shardings: Optional[Tree] = None
    ) -> Tuple[Tree, Dict[str, Any]]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_tree(self._path(step), like, shardings)

    # -- misc --------------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)


def _write(path: str, host: List[Tuple[str, Tuple[np.ndarray, str]]],
           extra: Dict[str, Any]) -> None:
    """Writes leaves already on the host to ``<path>.tmp``, then the
    manifest, then renames the directory to ``path``."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"leaves": [], "extra": extra}
    for key, (arr, dtype) in host:
        fname = key.replace(_SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)

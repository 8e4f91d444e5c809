"""AdamW's update and the gradients' global norm: the CUDA kernels and their plain version.

The kernels are ``csrc/adamw.cu`` (CUDA C++ for ``sm_90a``; the source says
that they replace no TPU kernel, what bounds them and what their design does
about it).  Here:

* :func:`adamw` — one AdamW step over a tree of leaves, in place: for CUDA
  tensors the ``norm`` kernels (skipped when the caller gives the norm) and
  one ``update`` launch a table of leaves, nothing else; for tensors on any
  other device the plain version.  ``adamw.launches_by_kernel`` counts the
  launches of the norm's kernels and of the update's (plain integers, raised
  where a kernel is launched and nowhere else);
* :func:`global_norm` — the norm alone, the same way;
* :func:`adamw_plain` / :func:`global_norm_plain` — the same arithmetic in
  PyTorch, leaf by leaf: what the CPU tests hold against the JAX reference
  and what the kernels are held against on the card.

A "tree" is a flat ``name -> tensor`` dict.  ``cfg`` is anything with the
fields of :class:`repro_torch.optim.AdamWConfig` that the step reads (``b1``,
``b2``, ``eps``, ``weight_decay``, ``grad_clip``); ``count`` (int32, the step's,
already advanced) and ``lr`` (float32) are 0-d tensors on the leaves' device.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, Optional

import torch

Tree = Mapping[str, torch.Tensor]

#: the kernels' counters: the norm (its partial sums and the launch that
#: finishes them) and the update
KERNELS = ("norm", "update")
_DTYPES = (torch.bfloat16, torch.float32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def global_norm_plain(tree: Tree) -> torch.Tensor:
    """``sqrt`` of the sum of every element's square, in float32."""
    total = None
    for x in tree.values():
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_plain(cfg, params: Tree, grads: Tree, mu: Tree, nu: Tree, count: torch.Tensor,
                lr: torch.Tensor, grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step leaf by leaf in PyTorch, in place; returns the norm it clipped by
    (``grad_norm``, or :func:`global_norm_plain` of ``grads``)."""
    dev = count.device
    gnorm = global_norm_plain(grads) if grad_norm is None else grad_norm
    scale = torch.minimum(_f32(1.0, dev), cfg.grad_clip / torch.clamp_min(gnorm, 1e-9))
    c = count.to(torch.float32)
    bias1 = 1 - _f32(cfg.b1, dev) ** c
    bias2 = 1 - _f32(cfg.b2, dev) ** c
    for k, p in params.items():
        m, v = mu[k], nu[k]
        g = grads[k].float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        del g
        step = (m / bias1).div_((v / bias2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        step.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(p32.sub_(step))   # for a float32 p, p32 is p: copy_ then does nothing
        del step, p32
    return gnorm


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FNS = None


def _kernel_fns():
    """The C entry points, built and bound on first use."""
    global _FNS
    if _FNS is None:
        from . import _build

        lib = _build.load()
        ptr, i32, out = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        f32 = ctypes.c_float
        norm = lib.repro_adamw_norm
        norm.argtypes = [ptr] * 3 + [i32] + [ptr] * 3 + [out]
        norm.restype = ctypes.c_int
        update = lib.repro_adamw_update
        update.argtypes = [ptr] * 7 + [i32] + [ptr] * 3 + [f32] * 7 + [ptr, out]
        update.restype = ctypes.c_int
        lib.repro_adamw_partials.argtypes = [i32]
        lib.repro_adamw_partials.restype = ctypes.c_longlong
        _FNS = norm, update, lib.repro_adamw_partials
    return _FNS


def _on_card(tree: Tree) -> bool:
    devices = {t.device for t in tree.values()}
    if len(devices) != 1:
        raise ValueError(f"all leaves must be on one device, got {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cuda"


def _check(name: str, t: torch.Tensor, dtypes, numel: int, device) -> None:
    if t.device != device:
        raise ValueError(f"adamw: {name} is on {t.device}, the leaves on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"adamw: {name} is {t.dtype}; the kernels take {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"adamw: {name} is not contiguous")
    if t.numel() != numel:
        raise ValueError(f"adamw: {name} has {t.numel()} elements, its parameter {numel}")


def _array(ctype, values: List):
    return (ctype * len(values))(*values)


def _raise(rc: int, what: str) -> None:
    why = "no leaves" if rc == -1 else f"CUDA error {rc}"
    raise RuntimeError(f"adamw {what} was not launched ({why})")


def _norm_into(grads: List[torch.Tensor], out: torch.Tensor) -> None:
    norm, _, partials = _kernel_fns()
    scratch = torch.empty(partials(len(grads)), dtype=torch.float64, device=out.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(out.device):
        rc = norm(_array(ctypes.c_void_p, [g.data_ptr() for g in grads]),
                  _array(ctypes.c_longlong, [g.numel() for g in grads]),
                  _array(ctypes.c_int, [int(g.dtype == torch.bfloat16) for g in grads]),
                  len(grads), scratch.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    adamw.launches_by_kernel["norm"] += launched.value
    if rc != 0:
        _raise(rc, "norm")


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt`` of the sum of every element's square, a 0-d float32 tensor:
    the ``norm`` kernels for CUDA leaves (contiguous, bfloat16 or float32;
    enqueued, nothing read back; the same bits on every run), the plain version
    for leaves on any other device."""
    if not tree:
        raise ValueError("global_norm of an empty tree")
    if not _on_card(tree):
        return global_norm_plain(tree)
    leaves = list(tree.values())
    device = leaves[0].device
    for k, g in tree.items():
        _check(f"grad {k!r}", g, _DTYPES, g.numel(), device)
    out = torch.empty((), dtype=torch.float32, device=device)
    _norm_into(leaves, out)
    return out


@torch.no_grad()
def adamw(cfg, params: Tree, grads: Tree, mu: Tree, nu: Tree, count: torch.Tensor,
          lr: torch.Tensor, grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One AdamW step over ``params`` in place (the moments ``mu`` / ``nu``
    too); returns the norm it clipped by, ``grad_norm`` if given, else the
    gradients' global norm.  CUDA leaves take the kernels or raise: parameters
    bfloat16 or float32, gradients bfloat16 or float32, moments float32, all
    contiguous with one element count a leaf, ``grad_norm`` a float32 scalar.
    Leaves on any other device take :func:`adamw_plain`."""
    if not params:
        raise ValueError("adamw of an empty tree")
    if not _on_card(params):
        return adamw_plain(cfg, params, grads, mu, nu, count, lr, grad_norm)
    if set(grads) != set(params) or set(mu) != set(params) or set(nu) != set(params):
        raise ValueError("adamw: params, grads and moments must have the same leaves")
    names = list(params)
    device = params[names[0]].device
    for k in names:
        n = params[k].numel()
        _check(f"param {k!r}", params[k], _DTYPES, n, device)
        _check(f"grad {k!r}", grads[k], _DTYPES, n, device)
        _check(f"mu {k!r}", mu[k], (torch.float32,), n, device)
        _check(f"nu {k!r}", nu[k], (torch.float32,), n, device)
    scalars = {"count": (count, torch.int32), "lr": (lr, torch.float32)}
    if grad_norm is not None:
        scalars["grad_norm"] = (grad_norm, torch.float32)
    for name, (t, dtype) in scalars.items():
        if t.device != device or t.dtype != dtype or t.numel() != 1:
            raise TypeError(f"adamw: {name} must be a {dtype} scalar on {device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if grad_norm is None:
        grad_norm = torch.empty((), dtype=torch.float32, device=device)
        _norm_into([grads[k] for k in names], grad_norm)
    _, update, _ = _kernel_fns()
    ptrs = {part: _array(ctypes.c_void_p, [tree[k].data_ptr() for k in names])
            for part, tree in (("p", params), ("g", grads), ("mu", mu), ("nu", nu))}
    launched = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = update(ptrs["p"], ptrs["g"], ptrs["mu"], ptrs["nu"],
                    _array(ctypes.c_longlong, [params[k].numel() for k in names]),
                    _array(ctypes.c_int, [int(params[k].dtype == torch.bfloat16) for k in names]),
                    _array(ctypes.c_int, [int(grads[k].dtype == torch.bfloat16) for k in names]),
                    len(names), grad_norm.data_ptr(), lr.data_ptr(), count.data_ptr(),
                    cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
                    cfg.grad_clip, torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(launched))
    adamw.launches_by_kernel["update"] += launched.value
    if rc != 0:
        _raise(rc, "update")
    for tree in (params, mu, nu):    # written in place, as PyTorch's own in-place ops mark it
        for t in tree.values():
            torch.autograd.graph.increment_version(t)
    return grad_norm


adamw.launches_by_kernel = {name: 0 for name in KERNELS}

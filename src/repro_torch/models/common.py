"""Shared model components: norms, rotary embeddings, initialisers, masks.

Counterpart of ``repro.models.common``: plain functions over tensors.  The
reference scans its layer stacks with ``jax.lax.scan``; the port loops over
the stacked leading axis in Python, so there is no ``scan`` here.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from ..kernels.ref import NEG_INF, floor_div

__all__ = [
    "NEG_INF", "trunc_normal", "trunc_normal_", "rms_norm", "layer_norm", "rope_frequencies",
    "rope_sin_cos", "apply_rope", "mrope_sin_cos", "apply_mrope", "swiglu", "gelu",
    "causal_mask_bias", "REMATS", "check_remat", "remat_call", "unrolled_scans",
    "layer_params",
]

# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)

#: the most elements a draw holds in float32 at once (256 MiB): a large leaf
#: is drawn block by block straight into its storage
DRAW_BLOCK = 1 << 26


def draw_blocks(t: torch.Tensor, limit: int) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its leading axes, in order, each of at most
    ``limit`` elements unless one row of the last axis holds more: a
    layer-stacked leaf goes a group of layers, one layer, or a part of one
    layer at a time."""
    if t.numel() <= limit or t.dim() == 1:
        yield t
        return
    row = t[0].numel()
    if row > limit:
        for part in t:
            yield from draw_blocks(part, limit)
        return
    step = limit // row
    for i in range(0, t.shape[0], step):
        yield t[i:i + step]


def trunc_normal_(out: torch.Tensor, generator: torch.Generator, std: float) -> torch.Tensor:
    """Fills ``out`` in place with a normal truncated to [-2, 2] standard
    deviations, times ``std``, and returns it.

    Drawn in fp32 by inverting the normal CDF on uniforms from ``generator``
    (which must live on ``out``'s device), then cast, :data:`DRAW_BLOCK`
    elements at a time at most (:func:`draw_blocks`): the fp32 temporary is
    one block's, never the leaf's.  The numbers differ from the
    reference's for the same seed: parity tests carry weights across instead.
    """
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    for part in draw_blocks(out, DRAW_BLOCK):
        u = torch.rand(part.shape, generator=generator, dtype=torch.float32, device=out.device)
        u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
        part.copy_(u.mul_(std))
    return out


def trunc_normal(
    generator: torch.Generator, shape: Sequence[int], std: float,
    dtype: torch.dtype = torch.float32, device="cpu",
) -> torch.Tensor:
    """A new tensor drawn by :func:`trunc_normal_`."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return trunc_normal_(out, generator, std)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the scale stored as an offset from one (``1 + w``)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Layer norm in fp32 with a plain scale and bias (no model calls it: the
    whisper backbone keeps RMSNorm, as the reference does)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10_000.0, device="cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def rope_sin_cos(
    positions: torch.Tensor,  # (B, S) integer
    head_dim: int,
    theta: float = 10_000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin, cos)`` of the rotation angles, each ``(B, S, 1, Dh/2)`` fp32.
    They depend on the positions and theta only, so a forward pass computes
    them once and hands them to every layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs  # (B, S, Dh/2)
    return torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]


def apply_rope(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S) integer
    theta: float = 10_000.0,
    sin_cos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Split-half rotary embedding: the two halves of the head are the pairs.
    ``sin_cos`` is :func:`rope_sin_cos` of the same positions and theta, if the
    caller has it already."""
    sin, cos = sin_cos if sin_cos is not None else rope_sin_cos(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: qwen2-vl's ``mrope_section`` in eighths: temporal, height, width
MROPE_SECTIONS = (2, 3, 3)


def mrope_sin_cos(
    positions: torch.Tensor,  # (B, S, 3) integer: temporal / height / width
    head_dim: int,
    theta: float = 1_000_000.0,
    sections: Tuple[int, int, int] = MROPE_SECTIONS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin, cos)`` of multimodal RoPE (qwen2-vl), each ``(B, S, 1, Dh/2)``
    fp32: the ``Dh/2`` frequencies are cut into three sections by Python's
    ``round(n * s / total)`` (the last bound forced to ``n``), and each
    section rotates by its own position stream."""
    n = head_dim // 2
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        acc += round(n * s / total)
        bounds.append(acc)
    bounds[-1] = n
    freq = torch.arange(n, device=positions.device)
    sec_id = (freq >= bounds[0]).long() + (freq >= bounds[1]).long()    # (n,) in {0, 1, 2}
    pos = positions.float()[..., sec_id]                                 # (B, S, n)
    angles = pos * rope_frequencies(head_dim, theta, device=positions.device)
    return torch.sin(angles)[:, :, None, :], torch.cos(angles)[:, :, None, :]


def apply_mrope(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S, 3) integer
    theta: float = 1_000_000.0,
    sections: Tuple[int, int, int] = MROPE_SECTIONS,
    sin_cos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Multimodal RoPE: the split-half rotation of :func:`apply_rope` with
    the angles of :func:`mrope_sin_cos` (``sin_cos``, if the caller has them)."""
    if sin_cos is None:
        sin_cos = mrope_sin_cos(positions, x.shape[-1], theta, sections)
    return apply_rope(x, None, sin_cos=sin_cos)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU by its tanh approximation, as the reference's ``approximate=True``."""
    return torch.nn.functional.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

#: the reference's remat options; ``dots`` and ``full`` both recompute the
#: whole layer body in backward here (``torch.utils.checkpoint`` has no
#: policy that keeps only the products)
REMATS = ("none", "dots", "full")


def check_remat(remat: str) -> str:
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}: one of {REMATS}")
    return remat


def remat_call(fn: Callable, remat: str, *args, **kwargs):
    """``fn(*args, **kwargs)``; under ``remat`` ``dots`` / ``full`` with
    gradients on, through ``torch.utils.checkpoint``, so that backward
    recomputes the body instead of keeping its activations (where the
    reference wraps its scan body in ``jax.checkpoint``)."""
    if check_remat(remat) == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def unrolled_scans():
    """The reference's dry-run switch: inside it every ``lax.scan`` of its
    model stack is unrolled, so that XLA's cost analysis counts each loop body
    once per iteration.  The port's layers are a Python loop, so every layer is
    always counted: ``rolled`` and ``unrolled`` give the same counts here, and
    this context manager changes nothing.  It is kept for the dry-run's
    ``--mode``."""
    yield


def layer_params(stack: Mapping[str, Any], i: int) -> Mapping[str, torch.Tensor]:
    """Layer ``i``'s parameters of a layer-stacked group (``{name: w[i]}``).
    A group that hands out its layers itself (``stack.layer(i)``: the meshed
    trainer's and the dry-run's :class:`repro_torch.sharding.GatheredStack`,
    which gathers each weight where the layer reads it) does so."""
    take = getattr(stack, "layer", None)
    if take is not None:
        return take(i)
    return {name: w[i] for name, w in stack.items()}


# ---------------------------------------------------------------------------
# Attention masks
# ---------------------------------------------------------------------------


def causal_mask_bias(
    q_positions: torch.Tensor,   # (B, Sq)
    kv_positions: torch.Tensor,  # (B, Skv)
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """(B, 1, Sq, Skv) additive fp32 bias: causal, optionally sliding-window
    or chunked.  As in the reference it does not test ``kp >= 0``: padding
    positions are the business of the chunked and kernel paths."""
    q = q_positions[:, None, :, None]
    k = kv_positions[:, None, None, :]
    ok = k <= q
    if window is not None:
        ok = ok & (k > q - window)
    if chunk is not None:
        ok = ok & (floor_div(k, chunk) == floor_div(q, chunk))
    bias = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    return bias.masked_fill_(~ok, NEG_INF)

"""Attention: grouped-query heads with three interchangeable inner paths.

Counterpart of ``repro.models.attention``:

* ``xla``      plain ``softmax(q k^T) v`` — materialises the ``(Sq, Skv)``
               scores; the semantic reference (the name is the reference's).
* ``chunked``  online softmax over KV chunks in a Python loop — the running
               ``(m, l, acc)`` stay in fp32 tensors across the loop instead of
               a full score matrix.  Peak memory ``O(Sq x kv_chunk)`` a head.
               Where autograd records a bfloat16 call on the card, the same
               function and its gradient run on the training kernels
               (:func:`repro_torch.kernels.train_attention.train_attention`).
* ``hopper``   the hand-written CUDA kernel
               (:func:`repro_torch.kernels.ops.flash_attention`): same
               recurrence with ``m / l / acc`` in registers.  The reference's
               ``pallas`` path cannot be reached from its model (per-layer
               ``window`` / ``chunk`` are traced there); here they are runtime
               integers of the kernel, so the model path really runs it.

All paths share the head grouping and mask conventions and are tested against
each other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import obs
from ..kernels.ref import attention_mask
from ..kernels.train_attention import takes_head_dim, train_attention
from .common import NEG_INF, causal_mask_bias

DEFAULT_CHUNK = 1024


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hq, Dh) by group broadcast."""
    b, s, hkv, dh = k.shape
    groups = n_q_heads // hkv
    if groups == 1:
        return k
    return k[:, :, :, None, :].expand(b, s, hkv, groups, dh).reshape(b, s, n_q_heads, dh)


def attention_xla(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    bias: Optional[torch.Tensor] = None,  # (B, 1, Sq, Skv) additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k = _expand_kv(k, q.shape[2])
    v = _expand_kv(v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def takes_train_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether :func:`attention_chunked` runs on the training kernels: q on
    the card, q, k and v in bfloat16, a head width the kernels take (a
    multiple of 16 up to 128), and autograd recording the call.  Every other
    call (the CPU, float32, ``no_grad`` and inference, wider heads) keeps the
    loop."""
    return (q.is_cuda and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and takes_head_dim(q.shape[-1]) and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad))


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,   # (B, Sq)
    kv_positions: torch.Tensor,  # (B, Skv)
    window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    scale: Optional[float] = None,
    kv_chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk``.

    As the reference, the last chunk is padded to full length with zero rows
    at position -1 (masked by ``kp >= 0``): for a row whose every key is
    masked, the padding takes part in the uniform average.  Where
    :func:`takes_train_kernel` holds, the training kernels compute the same,
    padding included.  With telemetry on, ``attn.chunked_kernel_calls`` or
    ``attn.chunked_loop_calls`` counts the call.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    n_chunks = -(-skv // kv_chunk)
    kernel = takes_train_kernel(q, k, v)
    if obs.enabled():
        name = "attn.chunked_kernel_calls" if kernel else "attn.chunked_loop_calls"
        obs.metrics().counter(name).inc()
    if kernel:
        return train_attention(q, k, v, q_positions, kv_positions, window, chunk_attn, scale,
                               pad_keys=n_chunks * kv_chunk)
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=-1)

    qf = q.float()
    qp = q_positions[:, None, :, None]
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hq, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kp = kv_positions[:, None, None, sl]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, sl].float()) * scale
        ok = attention_mask(qp, kp, window, chunk_attn)
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v[:, sl].float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    impl: str = "xla",
    window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    kv_chunk: int = DEFAULT_CHUNK,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unified entry point used by every architecture.  ``scale`` of the
    scores: ``1 / sqrt(Dh)`` unless given (Zamba2's shared blocks give
    ``(Dh / 2) ** -0.5``)."""
    if impl == "chunked":
        return attention_chunked(
            q, k, v, q_positions, kv_positions,
            window=window, chunk_attn=chunk_attn, kv_chunk=kv_chunk, scale=scale,
        )
    if k.dtype != q.dtype:
        # a float32 model attends over the bfloat16 cache: promote, as the
        # reference's mixed-type products do (the chunked path upcasts anyway)
        k, v = k.to(q.dtype), v.to(q.dtype)
    if impl == "hopper":
        from ..kernels import ops as kernel_ops

        return kernel_ops.flash_attention(
            q, k, v, q_positions, kv_positions, window=window, chunk_attn=chunk_attn, scale=scale
        )
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}: xla, chunked or hopper")
    bias = causal_mask_bias(q_positions, kv_positions, window=window, chunk=chunk_attn)
    return attention_xla(q, k, v, bias=bias, scale=scale)

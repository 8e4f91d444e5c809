"""Public wrappers of the port's kernels, in the model's layout.

Counterpart of ``repro.kernels.ops``.  ``flash_attention`` takes
``(B, S, H, Dh)`` operands with grouped-query heads and ``(B, S)`` positions.
Where the reference flattens ``(B, H)``, transposes and repeats K / V per
query group before its kernel, the CUDA kernel reads the model layout through
strides and maps query heads onto kv heads by index arithmetic, so this layer
copies nothing.  ``window`` / ``chunk_attn`` are runtime values (``None`` or
``BIG`` = unrestricted), which is what lets the model's per-layer masks reach
the kernel.

The device is that of the tensors: CUDA tensors run the kernel (or raise),
CPU tensors run its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa


def flash_attention(
    q: torch.Tensor,             # (B, Sq, Hq, Dh)
    k: torch.Tensor,             # (B, Skv, Hkv, Dh)
    v: torch.Tensor,             # (B, Skv, Hkv, Dh)
    q_positions: torch.Tensor,   # (B, Sq)
    kv_positions: torch.Tensor,  # (B, Skv)
    window: Optional[int] = None,
    chunk_attn: Optional[int] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """Model-layout flash attention with the running state kept on chip."""
    return fa.flash_attention(
        q, k, v, q_positions, kv_positions,
        window=window, chunk=chunk_attn, block_q=block_q, block_kv=block_kv,
    )

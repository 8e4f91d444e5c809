"""Public wrappers of the port's kernels, in the model's layout.

Counterpart of ``repro.kernels.ops``.  ``flash_attention`` takes
``(B, S, H, Dh)`` operands with grouped-query heads and ``(B, S)`` positions.
Where the reference flattens ``(B, H)``, transposes and repeats K / V per
query group before its kernel, the CUDA kernel reads the model layout through
strides and maps query heads onto kv heads by index arithmetic, so this layer
copies nothing.  ``window`` / ``chunk_attn`` are runtime values (``None`` or
``BIG`` = unrestricted), which is what lets the model's per-layer masks reach
the kernel.

``mamba2_ssd`` takes ``x (B, S, H, P)``, ``dt (B, S, H)``, ``a (H,)`` and
``bm`` / ``cm (B, S, N)`` as the reference's does, plus what the model's path
needs and the reference kernel lacks: any ``S``, an initial state ``h0``, and
``y`` in float32 (``out_dtype``).  The reference's ``chunk`` has no
counterpart (the kernel's chunk is its own, and the result does not depend on
it); its ``head_block`` becomes ``p_block``, the state rows one block owns.

The device is that of the tensors: CUDA tensors run the kernel (or raise),
CPU tensors run its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as fa
from . import mamba2_ssd as ssd


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


def mamba2_ssd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    bm: torch.Tensor,   # (B, S, N)
    cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N) float32
    p_block: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk scan with the recurrent state kept on chip; returns
    ``(y (B, S, H, P), h_last (B, H, P, N) float32)``."""
    return ssd.mamba2_ssd(x, dt, a, bm, cm, h0=h0, p_block=p_block, out_dtype=out_dtype)

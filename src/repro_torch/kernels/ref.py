"""Plain PyTorch oracle for the attention kernel (the ``ref.py`` contract).

Small and obviously correct: no chunking, no tiling, the full
``(Sq, Skv)`` score matrix.  Counterpart of ``repro.kernels.ref``
(``attention_reference``); the SSD oracle follows with the SSD kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: finite on purpose: a row whose every key is masked gets a uniform softmax
#: (the mean of the v rows), not NaN
NEG_INF = -1e30


def floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """Floor division of an integer tensor (what ``//`` means in the reference)."""
    return torch.div(x, d, rounding_mode="floor")


def attention_mask(
    q_positions: torch.Tensor,   # (..., Sq, 1) broadcastable
    kv_positions: torch.Tensor,  # (..., 1, Skv) broadcastable
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """The mask every attention path of the port shares: ``kp >= 0`` (padding
    carries -1), causal ``kp <= qp``, sliding window ``kp > qp - window``,
    chunked ``kp // chunk == qp // chunk``."""
    qp, kp = q_positions, kv_positions
    ok = (kp >= 0) & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if chunk is not None:
        ok = ok & (floor_div(kp, chunk) == floor_div(qp, chunk))
    return ok


def attention_reference(
    q: torch.Tensor,             # (BH, Sq, Dh)
    k: torch.Tensor,             # (BH, Skv, Dh)
    v: torch.Tensor,             # (BH, Skv, Dh)
    q_positions: torch.Tensor,   # (BH, Sq) integer
    kv_positions: torch.Tensor,  # (BH, Skv) integer
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    ok = attention_mask(q_positions[:, :, None], kv_positions[:, None, :], window, chunk)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)

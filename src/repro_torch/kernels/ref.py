"""Plain PyTorch oracles for the kernels (the ``ref.py`` contract).

Small and obviously correct: no chunking, no tiling — the full
``(Sq, Skv)`` score matrix for attention, the step-by-step recurrence for the
SSD scan.  Counterpart of ``repro.kernels.ref``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def ssd_reference(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    bm: torch.Tensor,   # (B, S, N)
    cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential state-space recurrence (the SSD ground truth), one step a
    token: ``h = exp(dt a) h + dt B x``, ``y = C h``.  Returns ``y`` in
    ``x``'s dtype and the last state in fp32; ``h0`` is the state before the
    first token (zeros if not given, as in the reference, which has none)."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    if h0 is None:
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    af = a.float()
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                                       # (B, H)
        decay = torch.exp(dtt * af[None, :])
        dbx = torch.einsum("bh,bn,bhp->bhpn", dtt, bm[:, t].float(), x[:, t].float())
        h = h * decay[:, :, None, None] + dbx
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h

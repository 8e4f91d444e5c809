"""Mamba2 (state-space duality / SSD) mixer — arXiv:2405.21060.

Counterpart of ``repro.models.mamba2``.  Prefill runs the SSD scan over the
prompt through one of two interchangeable paths:

* ``chunked``  :func:`ssd_chunked`, the reference's algorithm in PyTorch: the
               quadratic dual form within chunks of ``chunk`` rows, a Python
               loop over chunks carrying the ``(B, H, P, N)`` state;
* ``hopper``   the hand-written CUDA kernel
               (:func:`repro_torch.kernels.ops.mamba2_ssd`), with the state in
               registers across the chunk loop.  The reference's
               ``mamba_layer`` never reaches its own Pallas kernel; the port's
               does.

Decode is the O(1) recurrent update ``h = dA h + dt B x; y = C h`` in plain
PyTorch (:func:`ssd_decode_step`): the reference has no kernel for it.

On a mesh whose ``model`` axis is wider than 1, a layer is split by SSM
heads (:func:`split_products`): a rank computes its heads' ``z``, ``x`` and
``dt`` columns of ``in_proj``, and ``B`` / ``C`` whole (one group, which
every head reads), its heads' conv channels, scan and gated norm (the norm's
sum of squares summed over the axis), and its rows of ``out_proj``, summed
over the axis.  Its decode states hold its heads and its conv channels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import WHOLE, ModelAxis, Product, Segments
from .common import layer_params, rms_norm, trunc_normal_

D_CONV = 4  # depthwise causal conv width (mamba2 default)
N_GROUPS = 1

#: the parameters a mamba layer keeps in float32 whatever the model's dtype
FP32_LEAVES = ("a_log", "d_skip", "dt_bias")

SSD_IMPLS = ("chunked", "hopper")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def mamba_dims(d_model: int, ssm_heads: int, ssm_head_dim: int, d_state: int) -> Tuple[int, int]:
    d_inner = ssm_heads * ssm_head_dim
    conv_dim = d_inner + 2 * N_GROUPS * d_state
    return d_inner, conv_dim


def layer_shapes(
    d_model: int, ssm_heads: int, ssm_head_dim: int, d_state: int
) -> Dict[str, Tuple[int, ...]]:
    """``name -> shape`` of one layer's parameters (the reference's keys)."""
    H, P, N = ssm_heads, ssm_head_dim, d_state
    d_inner, conv_dim = mamba_dims(d_model, H, P, N)
    proj_out = 2 * d_inner + 2 * N_GROUPS * N + H  # z, x, B, C, dt
    return {
        "in_proj": (d_model, proj_out),
        "conv_w": (D_CONV, conv_dim),
        "conv_b": (conv_dim,),
        "a_log": (H,),
        "d_skip": (H,),
        "dt_bias": (H,),
        "norm": (d_inner,),
        "out_proj": (d_inner, d_model),
        "ln": (d_model,),
    }


def layer_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    """``name -> logical axes`` of one layer's parameters, the reference's
    (:func:`layer_shapes`' keys; a stack prepends ``"layers"``)."""
    return {
        "in_proj": ("embed", "ff"),
        "conv_w": (None, "ff"),
        "conv_b": ("ff",),
        "a_log": (None,),
        "d_skip": (None,),
        "dt_bias": (None,),
        "norm": ("ff",),
        "out_proj": ("ff", "embed"),
        "ln": ("embed",),
    }


def split_products(cfg, prefix: str = "mamba.") -> Dict[str, Product]:
    """The product the ``model`` axis splits in a stack of mamba layers
    (leaves ``prefix + name``, a leading layer dim): the SSM heads.  A rank
    reads its heads' columns of ``in_proj`` (``z`` and ``x``, ``P`` a head;
    ``dt``, one a head) and all of ``B`` / ``C``, the same of ``conv_w`` /
    ``conv_b`` (``x | B | C``), its heads of ``a_log`` / ``d_skip`` /
    ``dt_bias`` (which the rules replicate), and its blocks of ``norm`` and
    ``out_proj`` as they lie."""
    P, BC = cfg.ssm_head_dim, 2 * N_GROUPS * cfg.ssm_state
    proj = ((P, True), (P, True), (BC, False), (1, True))    # z | x | B C | dt
    conv = ((P, True), (BC, False))                          # x | B C
    head = ((1, True),)
    leaves: Dict[str, object] = {"in_proj": Segments(2, proj), "conv_w": Segments(2, conv),
                                 "conv_b": Segments(1, conv), "norm": 1, "out_proj": 1}
    leaves.update({k: Segments(1, head) for k in FP32_LEAVES})
    return {"ssm_heads": Product({prefix + k: d for k, d in leaves.items()}, cfg.ssm_heads)}


def leaf_dtype(leaf: str, dtype: torch.dtype) -> torch.dtype:
    """A layer parameter's dtype: ``a_log``, ``d_skip``, ``dt_bias`` are
    float32 in the reference whatever the model's dtype (rounding
    ``a = -exp(a_log)`` to bfloat16 would change every decay of the scan)."""
    return torch.float32 if leaf in FP32_LEAVES else dtype


def fill_mamba_layers(
    params: Dict[str, torch.Tensor], generator: torch.Generator, d_model: int
) -> None:
    """Draws a stack of layers (:func:`layer_shapes`' names, a leading layer
    axis) **in place** from ``generator``, which lives on their device, as
    the reference draws each layer: truncated normal projections (std
    ``1/sqrt(fan_in)``), conv std 0.2, ``a_log = log(linspace(1, 16, H))``,
    ``d_skip`` ones, biases and norm offsets zero."""
    for name, p in params.items():
        if name == "in_proj":
            trunc_normal_(p, generator, 1.0 / math.sqrt(d_model))
        elif name == "out_proj":
            trunc_normal_(p, generator, 1.0 / math.sqrt(p.shape[-2]))
        elif name == "conv_w":
            trunc_normal_(p, generator, 0.2)
        elif name == "a_log":
            p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[-1], device=p.device)))
        elif name == "d_skip":
            p.fill_(1.0)
        else:
            p.zero_()


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = sum_{j<t<=i} x[t]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) — post-softplus
    a: torch.Tensor,   # (H,) — negative decay rates
    bm: torch.Tensor,  # (B, S, G, N)
    cm: torch.Tensor,  # (B, S, G, N)
    chunk: int = 256,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) float32, final state (B,H,P,N) float32).  The
    reference's algorithm: the tail is zero-padded to a whole chunk, every
    chunk's state is computed at once and the inter-chunk recurrence is a
    loop over chunks (the reference's ``scan``)."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))

    Q = chunk
    xf = x.float().reshape(B, nc, Q, H, P)
    dtf = dt.float().reshape(B, nc, Q, H)
    bf = bm.float().reshape(B, nc, Q, N_GROUPS, N)[..., 0, :]  # (B,nc,Q,N)
    cf = cm.float().reshape(B, nc, Q, N_GROUPS, N)[..., 0, :]

    da = dtf * a.float()[None, None, None, :]  # (B, nc, Q, H) — negative
    da_cum = torch.cumsum(da, dim=2)           # within chunk
    da_total = da_cum[:, :, -1:, :]            # (B, nc, 1, H)

    # ---- intra-chunk (quadratic dual form) ---------------------------------
    # each contraction is one einsum of two operands, after element-wise
    # products: its matrix product is then the same whatever einsum path
    # PyTorch would pick for more operands
    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))        # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", cf, bf)      # (B, nc, Q, Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", L * scores[:, :, None], dtf[..., None] * xf)

    # ---- chunk states ------------------------------------------------------
    decay_to_end = torch.exp(da_total - da_cum)           # (B, nc, Q, H)
    states = torch.einsum("bcqn,bcqhp->bchpn", bf, (dtf * decay_to_end)[..., None] * xf)

    # ---- inter-chunk recurrence -------------------------------------------
    chunk_decay = torch.exp(da_total[:, :, 0, :])         # (B, nc, H)
    if h0 is None:
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                 # the state *before* chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B, nc, H, P, N)

    decay_from_start = torch.exp(da_cum)                  # (B, nc, Q, H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cf, h_prev) * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :S]
    return y, h


def ssd_decode_step(
    x: torch.Tensor,   # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    a: torch.Tensor,   # (H,)
    bm: torch.Tensor,  # (B, N)
    cm: torch.Tensor,  # (B, N)
    h: torch.Tensor,   # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    dtf = dt.float()
    da = torch.exp(dtf * a.float()[None, :])  # (B, H)
    dbx = (dtf[:, :, None] * bm.float()[:, None, :])[:, :, None, :] * x.float()[..., None]
    h_new = h * da[:, :, None, None] + dbx
    y = torch.einsum("bn,bhpn->bhp", cm.float(), h_new)
    return y, h_new


# ---------------------------------------------------------------------------
# Full mixer layer (conv frontend + SSD + gated output)
# ---------------------------------------------------------------------------


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (D_CONV, C), as the
    reference writes it: a sum of shifted scaled copies (D_CONV is tiny)."""
    pad = w.shape[0] - 1
    S = u.shape[1]
    uf = F.pad(u, (0, 0, pad, 0))
    out = uf[:, 0:S] * w[0]
    for i in range(1, w.shape[0]):
        out = out + uf[:, i:i + S] * w[i]
    return out + b


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, width: int,
                tp: ModelAxis) -> torch.Tensor:
    """``rms_norm(y * silu(z), scale)`` over all ``width`` channels; where
    ``tp`` splits the heads, ``y`` holds a rank's channels and their sum of
    squares is summed over the axis."""
    g = y * F.silu(z.float()).to(y.dtype)
    if not tp.splits("ssm_heads"):
        return rms_norm(g, scale)
    return rms_norm(g, scale, mean=lambda sq: tp.all_sum(
        sq.sum(dim=-1, keepdim=True), "ssm_heads") / width)


def mamba_layer(
    lp: Dict[str, torch.Tensor],
    h: torch.Tensor,  # (B, S, D)
    ssm_heads: int,
    ssm_head_dim: int,
    d_state: int,
    chunk: int = 256,
    ssm_state: Optional[torch.Tensor] = None,   # (B,H,P,N) for decode
    conv_state: Optional[torch.Tensor] = None,  # (B, D_CONV-1, conv_dim)
    decode: bool = False,
    ssd_impl: str = "chunked",
    tp: ModelAxis = WHOLE,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Returns (h_out, new_ssm_state, new_conv_state).

    Prefill (``decode=False``) starts from ``ssm_state`` (zeros if ``None``)
    and scans the prompt through ``ssd_impl``; the new conv state is the last
    ``D_CONV - 1`` pre-conv rows in the layer's dtype, which the caller's
    state buffer rounds as it stores them (bfloat16, as the reference keeps
    it: :func:`init_states`), or ``None`` for a prompt shorter than that
    (the caller keeps the old one, as the reference does).  Decode takes one
    token against both states.  Under ``tp`` the layer computes the heads
    of ``tp.range("ssm_heads")`` (``lp`` holds their columns,
    :func:`split_products`; the states theirs) and sums its part of the
    output over the ``model`` axis.
    """
    if ssd_impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {ssd_impl!r}: chunked or hopper")
    B, S, D = h.shape
    h0, h1 = tp.range("ssm_heads", ssm_heads)
    H, P, N = h1 - h0, ssm_head_dim, d_state
    d_inner, conv_dim = mamba_dims(D, H, P, N)

    res = h
    x = rms_norm(h, lp["ln"])
    proj = tp.enter(x, "ssm_heads") @ lp["in_proj"]  # (B, S, 2*d_inner + 2N + H)
    z, xbc, dt_raw = torch.split(proj, [d_inner, conv_dim, H], dim=-1)

    if decode:
        assert conv_state is not None
        window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        new_conv_state = window[:, 1:]
        xbc_c = (torch.einsum("bkc,kc->bc", window, lp["conv_w"]) + lp["conv_b"])[:, None, :]
    else:
        xbc_c = _causal_conv(xbc, lp["conv_w"], lp["conv_b"])
        new_conv_state = xbc[:, -(D_CONV - 1):, :] if S >= D_CONV - 1 else None
    xbc_c = F.silu(xbc_c)

    # column slices of xbc_c, no copy: the kernel reads them through strides
    xs, bm, cm = torch.split(xbc_c, [d_inner, N_GROUPS * N, N_GROUPS * N], dim=-1)
    xs = xs.reshape(B, -1, H, P)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"].float())  # (H,) negative

    if decode:
        assert ssm_state is not None
        y, new_state = ssd_decode_step(xs[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], ssm_state)
        y = y[:, None]  # (B, 1, H, P)
    elif ssd_impl == "hopper":
        from ..kernels import ops as kernel_ops

        # y in float32, as ssd_chunked gives it: the layer rounds once, below
        y, new_state = kernel_ops.mamba2_ssd(
            xs, dt, a, bm, cm, h0=ssm_state, out_dtype=torch.float32
        )
    else:
        y, new_state = ssd_chunked(
            xs, dt, a, bm.reshape(B, -1, N_GROUPS, N), cm.reshape(B, -1, N_GROUPS, N),
            chunk=chunk, h0=ssm_state,
        )

    y = y + xs.float() * lp["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, -1, d_inner).to(h.dtype)
    y = _gated_norm(y, z, lp["norm"], ssm_heads * P, tp)
    out = res + tp.leave(y @ lp["out_proj"], "ssm_heads").to(h.dtype)
    return out, new_state, new_conv_state


# ---------------------------------------------------------------------------
# A stack of layers (the ssm family; the hybrid's groups)
# ---------------------------------------------------------------------------


def init_states(
    cfg, batch: int, device: torch.device, tp: ModelAxis = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(L, B, H, P, N)`` float32 SSM states and ``(L, B, D_CONV-1,
    conv_dim)`` bfloat16 conv states, whatever ``cfg.dtype`` (as the
    reference); under ``tp`` a rank's: its heads, its conv channels (its
    heads' ``x`` and all of ``B`` / ``C``, :func:`rank_conv`)."""
    h0, h1 = tp.range("ssm_heads", cfg.ssm_heads)
    _, conv_dim = mamba_dims(cfg.d_model, h1 - h0, cfg.ssm_head_dim, cfg.ssm_state)
    L = cfg.n_layers
    ssm = torch.zeros((L, batch, h1 - h0, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    conv = torch.zeros((L, batch, D_CONV - 1, conv_dim), dtype=torch.bfloat16, device=device)
    return ssm, conv


def rank_conv(cfg, conv: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """A conv state whole along its channels (the last dim, ``x | B | C``)
    as a rank computes with it (:func:`init_states`): its heads' ``x`` and
    all of ``B`` / ``C``; ``conv`` itself where ``tp`` splits no heads."""
    if not tp.splits("ssm_heads"):
        return conv
    h0, h1 = tp.ranges["ssm_heads"]
    P, d_inner = cfg.ssm_head_dim, cfg.ssm_heads * cfg.ssm_head_dim
    return torch.cat([conv[..., h0 * P:h1 * P], conv[..., d_inner:]], dim=-1)


def whole_conv(cfg, conv: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """The inverse of :func:`rank_conv`: the ranks' ``x`` channels put
    together in rank order (gathered over the axis), then ``B`` / ``C``."""
    if not tp.splits("ssm_heads"):
        return conv
    bc = 2 * N_GROUPS * cfg.ssm_state
    x, rest = conv.split([conv.shape[-1] - bc, bc], dim=-1)
    return torch.cat([tp.gather(x, "ssm_heads"), rest], dim=-1)


def run_stack(
    cfg,
    layers: Dict[str, torch.Tensor],
    h: torch.Tensor,
    layer_ids: range,
    ssm_states: Optional[torch.Tensor],
    conv_states: Optional[torch.Tensor],
    decode: bool,
    ssd_impl: str,
    tp: ModelAxis = WHOLE,
) -> torch.Tensor:
    """The mamba layers ``layer_ids`` of the stack in order; writes each
    layer's new states into ``ssm_states[i]`` / ``conv_states[i]`` **in place**
    (a prompt too short for a conv state leaves that layer's as it was).
    ``ssm_states`` ``None`` (training) keeps no state.  ``tp``: the plan
    the layers compute under (the states a rank's, :func:`init_states`)."""
    for i in layer_ids:
        lp = layer_params(layers, i)
        h, new_ssm, new_conv = mamba_layer(
            lp, h, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, chunk=cfg.ssm_chunk,
            ssm_state=ssm_states[i] if decode else None,
            conv_state=conv_states[i] if decode else None,
            decode=decode, ssd_impl=ssd_impl, tp=tp,
        )
        if ssm_states is None:
            continue
        ssm_states[i] = new_ssm
        if new_conv is not None:
            conv_states[i] = new_conv
    return h

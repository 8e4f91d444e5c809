"""The plain reference of the zamba2 family (configurations whose ``reference``
is ``zamba2``): the float32 forward pass of Zamba2 as ``transformers``'
``modeling_zamba2.py`` writes it, and the counts of work the yardstick reads
(``harness.py`` gives the contract of such a module).

Written from the configuration file alone (its ``run`` block and the
``zamba2`` group in it), in plain PyTorch, with no kernel, cache or batching,
and importing nothing of the program under test:

* every layer is a Mamba2 mixer: RMSNorm, ``in_proj`` to ``z | x B C | dt``,
  a depthwise causal conv of width 4 and SiLU over ``x B C``, ``dt =
  softplus(dt + dt_bias)``, ``a = -exp(a_log)``, the SSD scan with ``G``
  groups of ``B`` / ``C`` (head ``h`` of ``H`` reads group ``h G / H``) plus
  ``D x``, the gated norm ``rmsnorm(y silu(z))`` over each group's channels,
  ``out_proj``, and the residual;
* before the layers of ``hybrid_layer_ids``, application ``j`` runs shared
  block ``j % mem_blocks`` on ``concat(h, e)`` (``e`` the embedding): RMSNorm,
  q / k / v, full split-half rotary, causal softmax at the scale
  ``(Dh / 2) ** -0.5``, ``o``, RMSNorm, ``gate_up`` plus the application's
  LoRA adapter, ``gelu(gate) * up``, ``down``; then the application's
  ``linear``, added to the next mamba layer's input before its norm (the
  layer's residual is its input without it);
* the final RMSNorm and the head tied to the embedding.

Every norm is ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` (the program's
convention for the published ``w``, which the configuration's departures
state).  The SSD scan is the chunked dual form at the configuration's chunk,
with the state carried between chunks, so that a sequence of 4k tokens takes
no more than a few chunks' memory.

Weights come in through ``leaf(name, layer)``: the benchmark's own tensors
(drawn from the seed), upcast to float32 one layer at a time.
``precision="fp8"`` is the control: every weight product's operands rounded
to float8 e4m3 (a scale per tensor) and multiplied in float32, the step below
the configuration's bfloat16; attention's products, the conv and the scan
stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Leaf = Callable[[str, Optional[int]], torch.Tensor]

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0
#: query rows an attention block scores at once
Q_BLOCK = 1024
#: the depthwise conv's width (``mamba_d_conv``)
D_CONV = 4

#: the ``run`` block's keys this reference models: a configuration that states
#: another (experts, a QKV bias, a window) names another reference
KEYS = frozenset({"n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "rope_theta", "tie_embeddings", "norm_eps", "dtype", "ssm_state", "ssm_heads",
                  "ssm_head_dim", "ssm_chunk", "zamba2"})


def _dims(run: Dict) -> Tuple[int, ...]:
    """``(D, H, P, N, G, d_inner, conv_dim)``."""
    D, H, P, N = run["d_model"], run["ssm_heads"], run["ssm_head_dim"], run["ssm_state"]
    G = run["zamba2"]["ssm_groups"]
    return D, H, P, N, G, H * P, H * P + 2 * G * N


def layout(run: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """``name -> (shape, std)`` of every leaf, in a fixed order: the normal
    each is drawn from (mean 0).  Products take ``1 / sqrt(fan_in)``; norms
    and biases about 0.02, as the embedding, so that a path that skipped one
    would show; ``a_log`` 0.5 (decays ``exp(-dt exp(a_log))``), ``d_skip``
    and ``dt_bias`` 0.5.  The conv takes 0.1: its output feeds the scan's
    three-way product ``C Bᵀ x``, and at a unit gain (0.5) the stack is
    chaotic at these depths (a relative error of 2e-3 a layer grows to 0.7
    in 81 layers: bfloat16 and float8 would read alike); at 0.1 it grows
    about as a random walk (0.05), and the scan's term stays as large as the
    skip's."""
    if set(run) - KEYS:
        raise ValueError(f"the zamba2 reference does not model {sorted(set(run) - KEYS)}")
    z = run["zamba2"]
    L, V, Hq, Hkv, Dh, F_ = (run["n_layers"], run["vocab"], run["n_heads"], run["n_kv_heads"],
                             run["head_dim"], run["d_ff"])
    D, H, P, N, G, d_inner, conv_dim = _dims(run)
    M, A, r = z["mem_blocks"], len(z["hybrid_layer_ids"]), z["adapter_rank"]
    proj = 2 * d_inner + 2 * G * N + H
    return {
        "embed": ((V, D), 0.02),
        "mamba.in_proj": ((L, D, proj), D ** -0.5),
        "mamba.conv_w": ((L, D_CONV, conv_dim), 0.1),
        "mamba.conv_b": ((L, conv_dim), 0.02),
        "mamba.a_log": ((L, H), 0.5),
        "mamba.d_skip": ((L, H), 0.5),
        "mamba.dt_bias": ((L, H), 0.5),
        "mamba.norm": ((L, d_inner), 0.02),
        "mamba.out_proj": ((L, d_inner, D), d_inner ** -0.5),
        "mamba.ln": ((L, D), 0.02),
        "shared.ln1": ((M, 2 * D), 0.02),
        "shared.wq": ((M, 2 * D, Hq * Dh), (2 * D) ** -0.5),
        "shared.wk": ((M, 2 * D, Hkv * Dh), (2 * D) ** -0.5),
        "shared.wv": ((M, 2 * D, Hkv * Dh), (2 * D) ** -0.5),
        "shared.wo": ((M, Hq * Dh, D), (Hq * Dh) ** -0.5),
        "shared.ln2": ((M, D), 0.02),
        "shared.w_gate_up": ((M, D, 2 * F_), D ** -0.5),
        "shared.w_down": ((M, F_, D), F_ ** -0.5),
        "apps.lora_a": ((A, D, r), D ** -0.5),
        "apps.lora_b": ((A, r, 2 * F_), r ** -0.5),
        "apps.linear": ((A, D, D), D ** -0.5),
        "final_ln": ((D,), 0.02),
    }


# -- the counts the yardstick reads ----------------------------------------------


def body_params(run: Dict, active: bool = True) -> int:
    """Parameters of the products a token passes through: each mamba layer's
    ``in_proj`` and ``out_proj``, and for each of the applications (13 in
    Zamba2-7B) its shared block's q, k, v, o, ``gate_up`` and ``down``, its
    adapter's two factors and its ``linear``: a shared block's weights count
    once a time a token passes through them.  Norms, the conv and the
    per-head vectors are not products."""
    z = run["zamba2"]
    Hq, Hkv, Dh, F_ = run["n_heads"], run["n_kv_heads"], run["head_dim"], run["d_ff"]
    D, H, P, N, G, d_inner, _ = _dims(run)
    mamba = D * (2 * d_inner + 2 * G * N + H) + d_inner * D
    block = 2 * D * (Hq + 2 * Hkv) * Dh + Hq * Dh * D + 3 * D * F_
    app = D * z["adapter_rank"] + z["adapter_rank"] * 2 * F_ + D * D
    return run["n_layers"] * mamba + len(z["hybrid_layer_ids"]) * (block + app)


def head_params(run: Dict) -> int:
    return run["d_model"] * run["vocab"]


def attention_layers(run: Dict) -> List[Tuple[int, int, int]]:
    """``(Hq, Hkv, Dh)`` of each application of a shared block: each attends
    causally over the whole sequence with a KV cache of its own."""
    return [(run["n_heads"], run["n_kv_heads"], run["head_dim"])] * len(
        run["zamba2"]["hybrid_layer_ids"])


def token_flops(run: Dict) -> int:
    """The work a token that is neither a product of :func:`body_params` nor
    attention, summed over the mamba layers.  A layer, with ``Q`` the chunk
    of the SSD's dual form (``ssm_chunk``):

    * the conv: ``2 x 4`` multiply-adds per channel of ``x B C``:
      ``8 conv_dim``;
    * the scan's dual form, per token: the scores ``C Bᵀ`` of its chunk, one
      row of ``Q`` dot products of ``N`` per group (``2 G Q N``); their
      product with ``dt x``, one row of ``Q`` by ``P`` per head (``2 H Q P``);
      ``C hᵀ`` from the state before the chunk (``2 H P N``) and the token's
      part of the chunk's state update ``Bᵀ u`` (``2 H P N``).

    Zamba2-7B: ``8 x 7,424 + 2·2·256·64 + 112 (2·256·64 + 4·64·64)`` =
    5,629,952 a layer, 456 M over 81 layers (products: 21.8 G a token)."""
    D, H, P, N, G, _, conv_dim = _dims(run)
    Q = run["ssm_chunk"]
    return run["n_layers"] * (8 * conv_dim + 2 * G * Q * N + H * (2 * Q * P + 4 * P * N))


# -- precision -------------------------------------------------------------------


def _fp8(t: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice over ``dims``."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32, or with both operands rounded to float8 first,
    a scale per tensor."""
    if precision == "fp8":
        x, w = _fp8(x, tuple(range(x.dim()))), _fp8(w, (-2, -1))
    return x @ w


# -- the layers ------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of ``x (S, H, Dh)`` at ``positions (S,)``
    (``transformers``' ``rotate_half``), over the whole head."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(0, 2 * half, 2, dtype=torch.float32,
                                         device=x.device) / (2 * half))
    ang = positions.float()[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Softmax attention of ``q (S, Hq, Dh)`` over ``k, v (S, Hkv, Dh)``, key
    ``j`` visible to query ``i`` iff ``j <= i``, scores times ``scale``;
    ``Q_BLOCK`` query rows at a time."""
    S, Hq, Dh = q.shape
    groups = Hq // k.shape[1]
    kh = k.repeat_interleave(groups, dim=1).transpose(0, 1)   # (Hq, S, Dh)
    vh = v.repeat_interleave(groups, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) * scale
    out = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2)
        mask = torch.arange(q1, device=q.device)[None] <= torch.arange(q0, q1, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ vh[:, :q1])
    return torch.cat(out, dim=1).transpose(0, 1)               # (S, Hq, Dh)


def shared_block(run: Dict, h: torch.Tensor, e: torch.Tensor, sp: Dict[str, torch.Tensor],
                 ap: Dict[str, torch.Tensor], precision: str) -> torch.Tensor:
    """One application over one sequence ``h, e (S, D)``: what is added to
    the next mamba layer's input."""
    S = h.shape[0]
    eps, Dh = run["norm_eps"], run["head_dim"]
    pos = torch.arange(S, device=h.device)
    x = rms_norm(torch.cat([h, e], dim=-1), sp["ln1"], eps)
    q = rope(linear(x, sp["wq"], precision).reshape(S, -1, Dh), pos, run["rope_theta"])
    k = rope(linear(x, sp["wk"], precision).reshape(S, -1, Dh), pos, run["rope_theta"])
    v = linear(x, sp["wv"], precision).reshape(S, -1, Dh)
    o = causal_attention(q, k, v, (Dh / 2) ** -0.5)
    x = rms_norm(linear(o.reshape(S, -1), sp["wo"], precision), sp["ln2"], eps)
    gu = linear(x, sp["w_gate_up"], precision) + linear(linear(x, ap["lora_a"], precision),
                                                        ap["lora_b"], precision)
    gate, up = gu.chunk(2, dim=-1)
    y = linear(F.gelu(gate) * up, sp["w_down"], precision)
    return linear(y, ap["linear"], precision)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """The SSD scan of one sequence by the chunked dual form: ``x (S, H, P)``,
    ``dt (S, H)``, ``a (H,)``, ``bm``, ``cm (S, H, N)`` (already each head's
    group); ``y (S, H, P)`` without the skip."""
    S, H, P = x.shape
    h = torch.zeros((H, P, bm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xc, dtc, bc, cc = x[c0:c0 + chunk], dt[c0:c0 + chunk], bm[c0:c0 + chunk], cm[c0:c0 + chunk]
        q = xc.shape[0]
        cum = torch.cumsum(dtc * a, dim=0).transpose(0, 1)                 # (H, q)
        diff = cum[:, :, None] - cum[:, None, :]                           # (H, i, j)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.where(tri, torch.exp(diff.masked_fill(~tri, 0.0)), torch.zeros_like(diff))
        scores = torch.einsum("ihn,jhn->hij", cc, bc)
        w = scores * decay * dtc.transpose(0, 1)[:, None, :]
        y = torch.einsum("hij,jhp->ihp", w, xc)
        y = y + torch.exp(cum).transpose(0, 1)[:, :, None] * torch.einsum("ihn,hpn->ihp", cc, h)
        ys.append(y)
        total = cum[:, -1]                                                 # (H,)
        u = xc * (dtc * torch.exp(total[None, :] - cum.transpose(0, 1)))[:, :, None]
        h = h * torch.exp(total)[:, None, None] + torch.einsum("jhn,jhp->hpn", bc, u)
    return torch.cat(ys, dim=0)


def mamba(run: Dict, h: torch.Tensor, lp: Dict[str, torch.Tensor], precision: str,
          add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One mamba layer over one sequence ``h (S, D)``; ``add`` (a shared
    block's output) joins the input before the norm, not the residual."""
    S = h.shape[0]
    D, H, P, N, G, d_inner, conv_dim = _dims(run)
    eps = run["norm_eps"]
    x = rms_norm(h if add is None else h + add, lp["ln"], eps)
    z, xbc, dt = linear(x, lp["in_proj"], precision).split([d_inner, conv_dim, H], dim=-1)
    w = lp["conv_w"]                                                       # (D_CONV, conv_dim)
    padded = F.pad(xbc, (0, 0, D_CONV - 1, 0))
    xbc = F.silu(sum(padded[i:i + S] * w[i] for i in range(D_CONV)) + lp["conv_b"])
    xs, bm, cm = xbc.split([d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    per = H // G                                                           # heads a group
    bm = bm.reshape(S, G, N).repeat_interleave(per, dim=1)
    cm = cm.reshape(S, G, N).repeat_interleave(per, dim=1)
    xs = xs.reshape(S, H, P)
    y = ssd(xs, dt, a, bm, cm, run["ssm_chunk"]) + xs * lp["d_skip"][None, :, None]
    g = (y.reshape(S, d_inner) * F.silu(z)).reshape(S, G, d_inner // G)
    g = rms_norm(g, lp["norm"].reshape(G, -1), eps).reshape(S, d_inner)
    return h + linear(g, lp["out_proj"], precision)


def _group(leaf: Leaf, run: Dict, prefix: str, i: int) -> Dict[str, torch.Tensor]:
    return {name.split(".", 1)[1]: leaf(name, i) for name in layout(run)
            if name.startswith(prefix + ".")}


@torch.no_grad()
def served_logits(run: Dict, leaf: Leaf, seqs: Sequence[Tuple[torch.Tensor, int]],
                  precision: str = "fp32") -> List[torch.Tensor]:
    """For each ``(tokens (S,), prompt_len)``: the float32 logits at positions
    ``prompt_len - 1 .. S - 1``, the positions whose argmax the program
    served.  Layer by layer over all sequences, so each layer's weights are
    upcast once; each sequence from position 0 as one pass (prefill and
    decode compute the same function)."""
    z = run["zamba2"]
    app_of = {layer: j for j, layer in enumerate(z["hybrid_layer_ids"])}
    embed = leaf("embed", None)
    es = [embed[t] for t, _ in seqs]
    hs = list(es)
    for i in range(run["n_layers"]):
        adds = [None] * len(seqs)
        if i in app_of:
            j = app_of[i]
            sp = _group(leaf, run, "shared", j % z["mem_blocks"])
            ap = _group(leaf, run, "apps", j)
            adds = [shared_block(run, h, e, sp, ap, precision) for h, e in zip(hs, es)]
            del sp, ap
        lp = _group(leaf, run, "mamba", i)
        hs = [mamba(run, h, lp, precision, add) for h, add in zip(hs, adds)]
        del lp
    fin = leaf("final_ln", None)
    return [linear(rms_norm(h[p - 1:], fin, run["norm_eps"]), embed.T, precision)
            for h, (_, p) in zip(hs, seqs)]

"""The plain reference of the dense and MoE families (configurations whose
``reference`` is ``model``): float32 forward passes, and the counts of work
the yardstick reads (``harness.py`` gives the contract of such a module).

Written from the configuration files alone (their ``run`` block), in plain
PyTorch, with no kernel, cache or batching, and importing nothing of the
program under test.  The layout is the one the files describe: layer-stacked
leaves (``layers.wq`` is ``(L, D, Hq * Dh)``, a product is ``x @ w``),
pre-norm blocks with RMSNorm (``x * rsqrt(mean(x^2) + eps) * (1 + w)``),
split-half rotary embeddings on the whole head, causal softmax attention,
SwiGLU, and for the ``moe`` family a softmax router with its top-k gates
divided by their sum, a gated shared expert, and the capacity rule that the
configuration file states as a departure: a forward pass of more than
``exact_max_tokens`` tokens keeps an expert's first ``ceil(T * k / E * cf)``
assignments in token order and drops the rest.

Weights come in through ``leaf(name, layer)``: the benchmark's own tensors
(drawn from the seed), upcast to float32 one layer at a time, so that the
reference fits beside whatever else is on the card.  ``precision="fp8"`` is
the control: every weight product's operands rounded to float8 e4m3 (a
scale per tensor) and multiplied in float32, the step below the configuration's bfloat16; attention's own
products stay float32.
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


#: the ``run`` block's keys this reference models: a configuration that states
#: another (a tied head, a window, state-space sizes) names another reference
KEYS = frozenset({"n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "rope_theta", "qkv_bias", "norm_eps", "dtype", "moe"})


def dh(run: Dict) -> int:
    return run.get("head_dim") or run["d_model"] // run["n_heads"]


def layout(run: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """``name -> (shape, std)`` of every leaf, in a fixed order: the normal
    each is drawn from.  Norms and biases are drawn too (about 0.02, as the
    embedding), so that a path that skipped one would show; the matrices take
    ``1 / sqrt(fan_in)``.  At these scales an AdamW step of 3e-4 is at least
    an ulp of a bfloat16 weight, so a bfloat16 program moves every leaf."""
    if set(run) - KEYS:
        raise ValueError(f"the dense and MoE reference does not model {sorted(set(run) - KEYS)}")
    L, D, V, Hq, Hkv, Dh = (run["n_layers"], run["d_model"], run["vocab"], run["n_heads"],
                            run["n_kv_heads"], dh(run))
    out: Dict[str, Tuple[Tuple[int, ...], float]] = {
        "embed": ((V, D), 0.02),
        "layers.ln1": ((L, D), 0.02),
        "layers.ln2": ((L, D), 0.02),
        "layers.wq": ((L, D, Hq * Dh), D ** -0.5),
        "layers.wk": ((L, D, Hkv * Dh), D ** -0.5),
        "layers.wv": ((L, D, Hkv * Dh), D ** -0.5),
        "layers.wo": ((L, Hq * Dh, D), (Hq * Dh) ** -0.5),
    }
    if run["qkv_bias"]:
        out.update({"layers.bq": ((L, Hq * Dh), 0.02), "layers.bk": ((L, Hkv * Dh), 0.02),
                    "layers.bv": ((L, Hkv * Dh), 0.02)})
    m = run["moe"]
    if m is None:
        F_ = run["d_ff"]
        out.update({"layers.w_gate": ((L, D, F_), D ** -0.5), "layers.w_up": ((L, D, F_), D ** -0.5),
                    "layers.w_down": ((L, F_, D), F_ ** -0.5)})
    else:
        E, Fe, Fs = m["n_experts"], m["d_ff_expert"], m["d_ff_shared"]
        out.update({
            "layers.router": ((L, D, E), D ** -0.5),
            "layers.we_gate": ((L, E, D, Fe), D ** -0.5), "layers.we_up": ((L, E, D, Fe), D ** -0.5),
            "layers.we_down": ((L, E, Fe, D), Fe ** -0.5),
            "layers.ws_gate": ((L, D, Fs), D ** -0.5), "layers.ws_up": ((L, D, Fs), D ** -0.5),
            "layers.ws_down": ((L, Fs, D), Fs ** -0.5),
        })
        if m["shared_gate"]:
            out["layers.ws_g"] = ((L, D, 1), D ** -0.5)
    out["final_ln"] = ((D,), 0.02)
    out["lm_head"] = ((D, V), D ** -0.5)
    return out


# -- the counts the yardstick reads ----------------------------------------------


def body_params(run: Dict, active: bool = True) -> int:
    """Parameters of the blocks' products that a token passes through: every
    matrix of attention and of the dense MLP; for a mixture of experts the
    router, ``top_k`` routed experts (all of them with ``active`` False),
    the shared expert and its gate.  Norms and biases are not products."""
    D, Hq, Hkv, Dh = run["d_model"], run["n_heads"], run["n_kv_heads"], dh(run)
    per = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
    m = run["moe"]
    if m is None:
        per += 3 * D * run["d_ff"]
    else:
        n = m["top_k"] if active else m["n_experts"]
        per += D * m["n_experts"] + 3 * n * D * m["d_ff_expert"] + 3 * D * m["d_ff_shared"]
        per += D if m["shared_gate"] else 0
    return run["n_layers"] * per


def head_params(run: Dict) -> int:
    return run["d_model"] * run["vocab"]


def attention_layers(run: Dict) -> List[Tuple[int, int, int]]:
    """``(Hq, Hkv, Dh)`` of each layer that attends, causal over the whole
    sequence: every layer here."""
    return [(run["n_heads"], run["n_kv_heads"], dh(run))] * run["n_layers"]


# -- precision -------------------------------------------------------------------


def _fp8(t: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice over ``dims``
    (its largest value mapped to the format's largest); the gradient passes
    straight through."""
    amax = t.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach() if t.requires_grad else q


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32, or with both operands rounded to float8 first,
    a scale per tensor: the activations of the call, each weight matrix (the
    per-tensor scaling of Hopper's float8 products)."""
    if precision == "fp8":
        x, w = _fp8(x, tuple(range(x.dim()))), _fp8(w, (-2, -1))
    return x @ w


# -- the block -------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of ``x (S, H, Dh)`` at ``positions (S,)``."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(0, 2 * half, 2, dtype=torch.float32,
                                         device=x.device) / (2 * half))
    ang = positions.float()[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of ``q (S, Hq, Dh)`` over ``k, v (S, Hkv, Dh)``, key
    ``j`` visible to query ``i`` iff ``j <= i``; scored ``Q_BLOCK`` query rows
    at a time."""
    S, Hq, Dh = q.shape
    groups = Hq // k.shape[1]
    kh = k.repeat_interleave(groups, dim=1).transpose(0, 1)   # (Hq, S, Dh)
    vh = v.repeat_interleave(groups, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / math.sqrt(Dh)
    out = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2)           # (Hq, b, q1)
        mask = torch.arange(q1, device=q.device)[None] <= torch.arange(q0, q1, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ vh[:, :q1])
    return torch.cat(out, dim=1).transpose(0, 1)               # (S, Hq, Dh)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
           precision: str) -> torch.Tensor:
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision), wd, precision)


def route(x: torch.Tensor, router: torch.Tensor, m: Dict,
          precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gate, expert)``, each ``(T, k)``: the softmax's top k by a stable
    descending sort (lower index first on a tie), gates divided by their sum."""
    probs = torch.softmax(linear(x, router, precision), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :m["top_k"]], expert[:, :m["top_k"]]
    if m["norm_topk"]:
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gate, expert


def kept(expert: torch.Tensor, m: Dict) -> torch.Tensor:
    """Which of the ``(T, k)`` assignments the capacity rule keeps: an
    expert's first ``C`` in token order (then by rank), ``C = ceil(T k / E cf)``."""
    T, k = expert.shape
    C = max(1, int(math.ceil(T * k / m["n_experts"] * m["capacity_factor"])))
    flat = expert.reshape(-1)
    onehot = F.one_hot(flat, m["n_experts"])
    before = onehot.cumsum(dim=0) - onehot                 # earlier assignments, per expert
    pos = before.gather(1, flat[:, None])[:, 0]
    return (pos < C).reshape(T, k)


def moe(x: torch.Tensor, lp: Dict[str, torch.Tensor], m: Dict, capacity: bool,
        precision: str) -> torch.Tensor:
    """The expert layer of ``x (T, D)``: routed experts (their gated sum, the
    capacity rule where ``capacity``) and the gated shared expert."""
    gate, expert = route(x, lp["router"], m, precision)
    if capacity:
        gate = gate * kept(expert, m)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(expert == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = swiglu(x[tok], lp["we_gate"][e], lp["we_up"][e], lp["we_down"][e], precision)
        y = y.index_add(0, tok, ye * gate[tok, slot][:, None])
    ys = swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"], precision)
    if m["shared_gate"]:
        ys = ys * torch.sigmoid(linear(x, lp["ws_g"], precision))
    return y + ys


def block(run: Dict, h: torch.Tensor, lp: Dict[str, torch.Tensor], prompt_len: int,
          precision: str) -> torch.Tensor:
    """One pre-norm block over one sequence ``h (S, D)`` at positions
    ``0..S-1``; rows below ``prompt_len`` were the prompt (one forward pass
    of the program), the rest were decoded one at a time."""
    S = h.shape[0]
    Hq, Hkv, Dh = run["n_heads"], run["n_kv_heads"], dh(run)
    pos = torch.arange(S, device=h.device)
    x = rms_norm(h, lp["ln1"], run["norm_eps"])
    q, k, v = (linear(x, lp[w], precision) for w in ("wq", "wk", "wv"))
    if run["qkv_bias"]:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rope(q.reshape(S, Hq, Dh), pos, run["rope_theta"])
    k = rope(k.reshape(S, Hkv, Dh), pos, run["rope_theta"])
    o = causal_attention(q, k, v.reshape(S, Hkv, Dh))
    h = h + linear(o.reshape(S, Hq * Dh), lp["wo"], precision)
    x = rms_norm(h, lp["ln2"], run["norm_eps"])
    m = run["moe"]
    if m is None:
        return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"], precision)
    capacity = prompt_len > m["exact_max_tokens"]
    y = torch.cat([moe(x[:prompt_len], lp, m, capacity, precision),
                   moe(x[prompt_len:], lp, m, False, precision)]) if prompt_len < S \
        else moe(x, lp, m, capacity, precision)
    return h + y


def layer(leaf: Leaf, run: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {name.split(".", 1)[1]: leaf(name, i) for name in layout(run) if name.startswith("layers.")}


@torch.no_grad()
def served_logits(run: Dict, leaf: Leaf, seqs: Sequence[Tuple[torch.Tensor, int]],
                  precision: str = "fp32") -> List[torch.Tensor]:
    """For each ``(tokens (S,), prompt_len)``: the float32 logits at positions
    ``prompt_len - 1 .. S - 1``, the positions whose argmax the program
    served.  Layer by layer over all sequences, so each layer's weights are
    upcast once."""
    embed = leaf("embed", None)
    hs = [embed[t] for t, _ in seqs]
    del embed
    for i in range(run["n_layers"]):
        lp = layer(leaf, run, i)
        hs = [block(run, h, lp, p, precision) for h, (_, p) in zip(hs, seqs)]
        del lp
    fin, head = leaf("final_ln", None), leaf("lm_head", None)
    return [linear(rms_norm(h[p - 1:], fin, run["norm_eps"]), head, precision)
            for h, (_, p) in zip(hs, seqs)]


# -- training --------------------------------------------------------------------


def train_loss(run: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
               targets: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy of one row ``tokens (S,)`` (targets
    ``< 0`` not counted), each block recomputed in backward."""
    h = params["embed"][tokens]
    S = tokens.shape[0]
    for i in range(run["n_layers"]):
        names = [n for n in params if n.startswith("layers.")]
        lp = [params[n][i] for n in names]

        def body(h, *ws, names=names):
            return block(run, h, {n.split(".", 1)[1]: w for n, w in zip(names, ws)}, S, precision)

        h = torch.utils.checkpoint.checkpoint(body, h, *lp, use_reentrant=False)
    logits = linear(rms_norm(h, params["final_ln"], run["norm_eps"]), params["lm_head"], precision)
    return F.cross_entropy(logits, targets.long(), ignore_index=-1)

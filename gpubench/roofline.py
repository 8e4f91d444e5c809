"""The yardstick's arithmetic: the card's peaks, the least time of an
attention launch, and model FLOPs of useful work (busy time, a union of
intervals, is ``trace.py``'s).

Peaks are NVIDIA's published ones for one H100 SXM (dense bf16 on the tensor
cores, HBM3), which assume its full 700 W; a run prints the card's power
limit beside every share of them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: bytes of a bf16 element
BF16 = 2


def bound_visible(q: torch.Tensor, k: torch.Tensor, qpos: torch.Tensor,
                  kpos: torch.Tensor) -> Dict[str, object]:
    """A frozen copy of ``chip_smoke.bound_visible`` (causal mask only): the
    least time of one attention launch counting only the K / V rows that some
    query row sees and the (query, key) pairs that are visible. ``q (B, Sq,
    Hq, Dh)``, ``k (B, Skv, Hkv, Dh)``, ``qpos (B, Sq)``, ``kpos (B, Skv)``."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    pairs = int(mask.sum())
    kv_rows = int(mask.any(1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * Hkv * Dh * k.element_size()
    nbytes += 4 * (B * Sq + k.shape[1] * B)
    flops = 4 * Hq * Dh * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return {"visible_pairs": pairs, "visible_kv_rows": kv_rows, "bytes": nbytes, "flops": flops,
            "seconds": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_row_bound(first: int, rows: int, cache_len: int, Hq: int, Hkv: int,
                        Dh: int) -> Tuple[int, int]:
    """``(flops, bytes)`` of :func:`bound_visible` in closed form for one
    sequence whose ``rows`` queries sit at positions ``first .. first+rows-1``
    of a cache of ``cache_len`` positions ``0 .. cache_len-1``, causal."""
    last = first + rows - 1
    pairs = rows * (first + last + 2) // 2
    kv_rows = last + 1
    nbytes = 2 * rows * Hq * Dh * BF16 + 2 * kv_rows * Hkv * Dh * BF16 + 4 * (rows + cache_len)
    return 4 * Hq * Dh * pairs, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def serve_attention_seconds(run: Dict, max_len: int,
                            requests: Iterable[Tuple[int, int]]) -> float:
    """The least time the card could take for the attention launches that
    ``requests`` (``(prompt_len, tokens served)``) need: per layer, the
    prompt's one causal launch, then one row a decoded token (query at
    ``prompt_len + i - 1``, keys ``0 ..`` it).  A decode row is bound by its
    bytes at every grouping (its operations per byte are the query heads per
    K / V head), so rows that shared a launch add up as the launch would."""
    Hq, Hkv, Dh, L = run["n_heads"], run["n_kv_heads"], head_dim(run), run["n_layers"]
    total = 0.0
    for prompt, served in requests:
        total += least_seconds(*attention_row_bound(0, prompt, max_len, Hq, Hkv, Dh))
        for i in range(1, served):
            total += least_seconds(*attention_row_bound(prompt + i - 1, 1, max_len, Hq, Hkv, Dh))
    return L * total


def head_dim(run: Dict) -> int:
    return run.get("head_dim") or run["d_model"] // run["n_heads"]


def body_params(run: Dict, active: bool = True) -> int:
    """Parameters of the blocks' products that a token passes through: every
    matrix of attention and of the dense MLP; for a mixture of experts the
    router, ``top_k`` routed experts (all of them with ``active`` False),
    the shared expert and its gate.  Norms and biases are not products."""
    D, Hq, Hkv, Dh = run["d_model"], run["n_heads"], run["n_kv_heads"], head_dim(run)
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


def attention_flops(run: Dict, pairs: int) -> int:
    """The two products (scores, then values) over ``pairs`` visible pairs,
    every layer and query head."""
    return 4 * run["n_layers"] * run["n_heads"] * head_dim(run) * pairs


def serve_flops(run: Dict, prompt: int, served: int) -> int:
    """Model FLOPs of one served request: the prompt's products (the head on
    its last position only, as serving needs) and causal attention, then each
    decoded token's products, head and attention over the keys before it."""
    body, head = body_params(run), head_params(run)
    flops = 2 * body * prompt + 2 * head + attention_flops(run, prompt * (prompt + 1) // 2)
    for i in range(1, served):
        flops += 2 * (body + head) + attention_flops(run, prompt + i)
    return flops


def train_flops(run: Dict, seq_len: int, rows: int) -> int:
    """Model FLOPs of a training step: 6 x the products' parameters (the head
    included, the embedding table not) a token, and the causal attention's
    forward and backward products (3 x the forward's). Recomputation does
    not count."""
    per_row = 6 * (body_params(run) + head_params(run)) * seq_len
    per_row += 3 * attention_flops(run, seq_len * (seq_len + 1) // 2)
    return rows * per_row


def share(part: float, whole: float) -> Optional[float]:
    """``part / whole`` in percent, or None where nothing was measured."""
    if not whole or part is None:
        return None
    return 100.0 * part / whole

"""The yardstick's arithmetic: the card's peaks, the least time of an
attention launch, and model FLOPs of useful work (busy time, a union of
intervals, is ``trace.py``'s).  What depends on the model family (the
products' parameters, which layers attend and how, further work a token)
comes from the configuration's reference module (``harness.reference``);
without one, from the dense and MoE families'.

Peaks are NVIDIA's published ones for one H100 SXM (dense bf16 on the tensor
cores, HBM3), which assume its full 700 W; a run prints the card's power
limit beside every share of them.
"""

from __future__ import annotations

from collections import Counter
from types import ModuleType
from typing import Dict, Iterable, Optional, Tuple

import torch

from gpubench import harness

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


def family(ref: Optional[ModuleType]) -> ModuleType:
    """The reference module whose counts a run is measured by."""
    return ref or harness.reference_module(harness.DEFAULT_REFERENCE)


def serve_attention_seconds(run: Dict, max_len: int, requests: Iterable[Tuple[int, int]],
                            ref: Optional[ModuleType] = None) -> float:
    """The least time the card could take for the attention launches that
    ``requests`` (``(prompt_len, tokens served)``) need: in each layer that
    attends, the prompt's one causal launch, then one row a decoded token
    (query at ``prompt_len + i - 1``, keys ``0 ..`` it).  A decode row is
    bound by its bytes at every grouping (its operations per byte are the
    query heads per K / V head), so rows that shared a launch add up as the
    launch would."""
    requests = list(requests)
    out = 0.0
    for (Hq, Hkv, Dh), layers in Counter(family(ref).attention_layers(run)).items():
        total = 0.0
        for prompt, served in requests:
            total += least_seconds(*attention_row_bound(0, prompt, max_len, Hq, Hkv, Dh))
            for i in range(1, served):
                total += least_seconds(*attention_row_bound(prompt + i - 1, 1, max_len, Hq, Hkv,
                                                            Dh))
        out += layers * total
    return out


def attention_flops(run: Dict, pairs: int, ref: Optional[ModuleType] = None) -> int:
    """The two products (scores, then values) over ``pairs`` visible pairs,
    every layer that attends and its query heads."""
    return 4 * sum(Hq * Dh for Hq, _, Dh in family(ref).attention_layers(run)) * pairs


def serve_flops(run: Dict, prompt: int, served: int, ref: Optional[ModuleType] = None) -> int:
    """Model FLOPs of one served request: the prompt's products (the head on
    its last position only, as serving needs), causal attention and further
    work a token, then each decoded token's products, head, attention over
    the keys before it and further work."""
    ref = family(ref)
    body, head = ref.body_params(run), ref.head_params(run)
    other = getattr(ref, "token_flops", lambda run: 0)(run)
    flops = (2 * body * prompt + 2 * head + other * prompt
             + attention_flops(run, prompt * (prompt + 1) // 2, ref))
    for i in range(1, served):
        flops += 2 * (body + head) + other + attention_flops(run, prompt + i, ref)
    return flops


def train_flops(run: Dict, seq_len: int, rows: int, ref: Optional[ModuleType] = None) -> int:
    """Model FLOPs of a training step: 6 x the products' parameters (the head
    included, the embedding table not) a token, and 3 x the forward's causal
    attention and further work a token (forward and backward).
    Recomputation does not count."""
    ref = family(ref)
    other = getattr(ref, "token_flops", lambda run: 0)(run)
    per_row = 6 * (ref.body_params(run) + ref.head_params(run)) * seq_len
    per_row += 3 * attention_flops(run, seq_len * (seq_len + 1) // 2, ref)
    per_row += 3 * other * seq_len
    return rows * per_row


def share(part: float, whole: float) -> Optional[float]:
    """``part / whole`` in percent, or None where nothing was measured."""
    if not whole or part is None:
        return None
    return 100.0 * part / whole

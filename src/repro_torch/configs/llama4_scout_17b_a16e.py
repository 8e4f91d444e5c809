"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) vocab=202048.

MoE 16 experts top-1 + shared expert (d_ff 8192); iRoPE: chunked local
attention (8192) with NoPE global layers every 4th layer.  The text
backbone only — early-fusion vision is out of the assigned scope.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

import dataclasses

from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    head_dim=128,
    rope_theta=500_000.0,
    global_period=4,
    attn_chunk=8192,
    nope_on_global=True,
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_ff_expert=8192,
        n_shared=1,
        d_ff_shared=8192,
        norm_topk=False,
    ),
    notes=(
        "16 routed top-1 + shared expert; E=16 divides model=16 -> clean EP; "
        "chunked 8k attention -> long_500k RUNS (sub-quadratic)"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="llama4_scout_smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, attn_chunk=32,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1,
                  d_ff_shared=128, norm_topk=False),
)

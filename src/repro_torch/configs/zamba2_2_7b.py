"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000.

Mamba2 backbone (d_state 64, d_inner 5120, head_dim 64 -> 80 SSM heads)
with a weight-SHARED full-attention block applied every 6 layers.
[arXiv:2411.15242; hf]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32_000,
    tie_embeddings=True,
    ssm_state=64,
    ssm_heads=80,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_period=6,
    notes=(
        "Mamba2 + shared attn every 6 layers (9 applications, one weight "
        "set); long_500k RUNS (SSM decode O(1), attn decode O(S) reads)"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="zamba2_smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=16, attn_period=3,
)

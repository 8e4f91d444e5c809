"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280.

SSD (state-space duality): d_inner = 2*d_model = 2048, head_dim 64 ->
32 SSM heads, d_state 128. [arXiv:2405.21060; unverified]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    ssm_chunk=256,
    notes=(
        "attention-free; RegDem-kernel demotion applies to the SSD chunk "
        "state (see DESIGN.md §Arch-applicability); long_500k RUNS (O(1) "
        "state decode)"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="mamba2_smoke", n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=16,
)

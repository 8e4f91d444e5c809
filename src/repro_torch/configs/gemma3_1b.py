"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global attention (window 512), 10k local / 1M global RoPE theta.
[hf:google/gemma-3-1b-pt; unverified]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262_144,
    head_dim=256,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    global_period=6,          # 5 local : 1 global
    window=512,
    notes="5:1 local:global (window 512); long_500k RUNS (sub-quadratic local)",
)

REDUCED = dataclasses.replace(
    CONFIG, name="gemma3_1b_smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=512, head_dim=16, window=16,
)

"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope_theta=10_000.0,
    notes="MHA (kv=32); full attention — long_500k skipped per assignment",
)

REDUCED = dataclasses.replace(
    CONFIG, name="stablelm_3b_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
)

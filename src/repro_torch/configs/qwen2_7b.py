"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671; hf]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="GQA kv=4, QKV bias; full attention — long_500k skipped per assignment",
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2_7b_smoke", n_layers=2, d_model=56, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
)

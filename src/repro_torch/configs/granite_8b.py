"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

Llama-architecture code model. [arXiv:2405.04324; hf]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite_8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000_000.0,
    notes="llama-arch; full attention — long_500k skipped per assignment",
)

REDUCED = dataclasses.replace(
    CONFIG, name="granite_8b_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab=256,
)

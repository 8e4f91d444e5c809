"""whisper-large-v3 [audio]: 32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.

Encoder-decoder; the conv mel frontend is a STUB (the caller gives
precomputed frame embeddings, 1500 frames = 30 s).  Decoder max position 448.
[arXiv:2212.04356; unverified]
"""

import dataclasses

from repro_torch.models import ModelConfig

N_FRAMES = 1500

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    notes=(
        "enc-dec backbone; conv frontend stubbed with frame embeddings; "
        "decode cells: 1500 enc frames + (seq_len-1500) decoder budget; "
        "long_500k skipped (decoder max pos 448, quadratic cross-attn)"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="whisper_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
)

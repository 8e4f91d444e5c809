"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (temporal/height/width sections) with dynamic-resolution patches;
the vision frontend is a STUB — precomputed patch embeddings come in
through ``Model.prefill``'s ``patch_embeds``. [arXiv:2409.12191; hf]
"""

import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    mrope=True,
    rope_theta=1_000_000.0,
    notes=(
        "M-RoPE backbone; patch embeddings precomputed (frontend stub); "
        "full attention — long_500k skipped per assignment"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2_vl_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
)

#: patch tokens occupying the sequence prefix in vlm shape cells
N_PATCHES = 256

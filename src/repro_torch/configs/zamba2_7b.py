"""zamba2-7b [zamba2]: 81L d_model=3584, every layer a Mamba2 mixer (112 heads
of 64, state 64, 2 B / C groups), 13 of them after one of 2 shared attention
blocks (32 heads of 224 over the 7,168-wide concatenated embedding, d_ff
14,336, a rank-128 adapter and a linear per application), vocab 32000 tied.

Zyphra/Zamba2-7B-Instruct as published
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json), at
its widths and depth, with the equations of ``transformers``'
``modeling_zamba2.py`` (:mod:`repro_torch.models.zamba2`).  Port-only: the
reference has no such configuration, so it is not in ``ARCH_IDS``;
``get_config("zamba2_7b")`` resolves it.
"""

import dataclasses

from repro_torch.models import ModelConfig, Zamba2Config

#: where the port departs from the published model, and why
DEPARTURES = (
    "norms: each RMSNorm's scale is stored as an offset from one (the port's 1 + w), "
    "where the published weight is the scale itself; the same function",
    "dt: softplus(dt + dt_bias) unclamped, as the published model's CUDA path (mamba_ssm, "
    "time_step_limit null) computes it; transformers' plain-PyTorch fallback also clamps "
    "dt below at time_step_min",
    "the SSD scan walks chunks of 64 rows in the kernel (the published chunk_size is 256): "
    "the same function in exact arithmetic",
    "the KV caches and the conv states are bfloat16, the SSM states float32",
    "serving only: no training path (the SSD kernel has no backward)",
)

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ModelConfig(
    name="zamba2_7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32_000,
    tie_embeddings=True,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_heads=112,
    ssm_head_dim=64,
    ssm_chunk=256,
    zamba2=Zamba2Config(hybrid_layer_ids=HYBRID_LAYER_IDS, mem_blocks=2, adapter_rank=128,
                        ssm_groups=2, activation="gelu"),
    notes="Zamba2-7B: 81 Mamba2 layers, 13 applications of 2 alternating shared blocks",
)

REDUCED = dataclasses.replace(
    CONFIG, name="zamba2_7b_smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=128, vocab=256, ssm_state=16, ssm_heads=8, ssm_head_dim=16,
    ssm_chunk=16,
    zamba2=Zamba2Config(hybrid_layer_ids=(3, 5, 7), mem_blocks=2, adapter_rank=4,
                        ssm_groups=2, activation="gelu"),
)

"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) vocab=151936.

MoE: 60 routed experts (d_ff 1408) top-4 + shared expert block of 4x1408
with a sigmoid shared-expert gate. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

import dataclasses

from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared=4,
        d_ff_shared=4 * 1408,
        shared_gate=True,
        norm_topk=True,
    ),
    notes=(
        "60 routed top-4 + 4 shared experts; E=60 does not divide model=16 "
        "so experts use TP-inside-expert sharding (ff_expert over model); "
        "full attention — long_500k skipped per assignment"
    ),
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2_moe_smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=96, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1,
                  d_ff_shared=192, shared_gate=True),
)

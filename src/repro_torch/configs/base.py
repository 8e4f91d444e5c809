"""Config registry of the port.

Counterpart of ``repro.configs.base``.  Every ported architecture is
selectable by id; ``reduced_config`` gives the small smoke-test variant of
the same family.  ``CONFIG`` and ``REDUCED`` of each module equal the
reference's field for field (``dtype`` is the torch type).  ``ARCH_IDS``
lists only what is ported so far; the shape cells of the dry-run follow with
the launch slice.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models import ModelConfig
from repro_torch.models.mamba2 import mamba_dims

ARCH_IDS = [
    "stablelm_3b",
    "gemma3_1b",
    "qwen2_7b",
    "granite_8b",
    "mamba2_370m",
    "zamba2_2_7b",
]


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"config {arch!r} is not ported yet; ported so far: {', '.join(ARCH_IDS)}"
        )
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def param_count(cfg: ModelConfig) -> int:
    """Parameter count by the reference's formula, for the ported families.

    Exact for the dense family but for the final norm.  For ``ssm`` and
    ``hybrid`` the reference also leaves out a mamba layer's ``conv_b`` and its
    three per-head vectors (``a_log``, ``d_skip``, ``dt_bias``), and the hybrid's
    two shared-block norms; the port keeps the formula so that the two counts
    stay equal."""
    if cfg.family not in ("dense", "ssm", "hybrid") or cfg.moe is not None:
        raise NotImplementedError(f"param_count: family {cfg.family!r} is not ported yet")
    D, L, V, F = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    total = V * D  # embed
    if cfg.family == "dense":
        if not cfg.tie_embeddings:
            total += D * V
        per = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 2 * D
        if cfg.qkv_bias:
            per += Hq * Dh + 2 * Hkv * Dh
        per += 3 * D * F
        return total + L * per
    d_inner, conv_dim = mamba_dims(D, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    proj = 2 * d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    total += L * (D * proj + 4 * conv_dim + d_inner * D + d_inner + D)
    if cfg.family == "hybrid":  # the one shared block
        total += D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 3 * D * F
    return total

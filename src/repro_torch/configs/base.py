"""Config registry of the port.

Counterpart of ``repro.configs.base``.  Every ported architecture is
selectable by id; ``reduced_config`` gives the small smoke-test variant of
the same family.  ``CONFIG`` and ``REDUCED`` of each module equal the
reference's field for field (``dtype`` is the torch type).  ``shape_cells``
returns the dry-run's (shape-name, :class:`ShapeCell`) cells of an
architecture, with the reference's skips and their reasons.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.models import ModelConfig, param_shapes
from repro_torch.models.mamba2 import mamba_dims

ARCH_IDS = [
    "stablelm_3b",
    "gemma3_1b",
    "qwen2_7b",
    "granite_8b",
    "qwen2_moe_a2_7b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_2b",
    "whisper_large_v3",
    "mamba2_370m",
    "zamba2_2_7b",
]
#: configurations of the port alone (no counterpart in the reference):
#: ``get_config`` resolves them, ``ARCH_IDS`` and ``all_configs`` leave them out
PORT_ONLY_IDS = ["zamba2_7b"]


@dataclass(frozen=True)
class ShapeCell:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    skip_reason: Optional[str] = None

    @property
    def skipped(self) -> bool:
        return self.skip_reason is not None


SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

#: archs whose attention is full/quadratic with no sub-quadratic mode:
#: long_500k is skipped per the assignment.
_FULL_ATTENTION = {
    "stablelm_3b": "pure full attention (quadratic); long_500k skipped per assignment",
    "qwen2_7b": "pure full attention (quadratic); long_500k skipped per assignment",
    "granite_8b": "pure full attention (quadratic); long_500k skipped per assignment",
    "qwen2_moe_a2_7b": "pure full attention (quadratic); long_500k skipped per assignment",
    "qwen2_vl_2b": "pure full attention (quadratic); long_500k skipped per assignment",
    "whisper_large_v3": "enc-dec with 1500-frame encoder and 448-pos decoder; 500k ill-defined",
}


def shape_cells(arch: str) -> List[ShapeCell]:
    arch = arch.replace("-", "_")
    cells = []
    for name, (seq, batch, kind) in SHAPES.items():
        skip = None
        if name == "long_500k" and arch in _FULL_ATTENTION:
            skip = _FULL_ATTENTION[arch]
        cells.append(
            ShapeCell(name=name, seq_len=seq, global_batch=batch, kind=kind, skip_reason=skip)
        )
    return cells


def _module(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS and arch not in PORT_ONLY_IDS:
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
    """Parameter count by the reference's formula, for every family.

    Exact for the dense, moe and vlm families but for the final norm (and
    the vlm's ``patch_proj``).  For ``ssm`` and ``hybrid`` the reference also
    leaves out a mamba layer's ``conv_b`` and its three per-head vectors
    (``a_log``, ``d_skip``, ``dt_bias``), and the hybrid's two shared-block
    norms; for ``audio`` every norm (``ln1``, ``ln2``, ``lnx``, ``enc_ln``,
    ``final_ln``).  The port keeps the formula so that the two counts stay
    equal.  A family of the port alone (zamba2), which the reference has no
    formula for, is counted exactly: every leaf of its ``param_shapes`` (an
    unknown family raises there)."""
    D, L, V, F = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    total = V * D  # embed
    if cfg.family in ("dense", "moe", "vlm"):
        if not cfg.tie_embeddings:
            total += D * V
        per = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 2 * D
        if cfg.qkv_bias:
            per += Hq * Dh + 2 * Hkv * Dh
        if cfg.moe is None:
            per += 3 * D * F
        else:
            m = cfg.moe
            per += D * m.n_experts + 3 * m.n_experts * D * m.d_ff_expert
            if m.n_shared:
                per += 3 * D * m.d_ff_shared + (D if m.shared_gate else 0)
        return total + L * per
    if cfg.family == "audio":   # encoder and decoder stacks, frame_proj, tied head
        per_enc = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 3 * D * F
        per_dec = per_enc + D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        return total + L * (per_enc + per_dec) + D * D
    if cfg.family in ("ssm", "hybrid"):
        d_inner, conv_dim = mamba_dims(D, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        proj = 2 * d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        total += L * (D * proj + 4 * conv_dim + d_inner * D + d_inner + D)
        if cfg.family == "hybrid":  # the one shared block
            total += D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 3 * D * F
        return total
    return sum(math.prod(shape) for shape in param_shapes(cfg).values())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token passes through: :func:`param_count` but for a
    mixture of experts, where only ``top_k`` routed experts count (and, as in
    the reference, neither the norms nor the shared expert's gate)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    D, L = cfg.d_model, cfg.n_layers
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    total = cfg.vocab * D
    if not cfg.tie_embeddings:
        total += D * cfg.vocab
    per = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
    per += D * m.n_experts + 3 * m.top_k * D * m.d_ff_expert
    if m.n_shared:
        per += 3 * D * m.d_ff_shared
    return total + L * per

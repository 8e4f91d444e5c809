"""On-chip residency policies — the program-level register-demotion analogue.

Counterpart of ``repro.core.vmem_demotion`` (the file keeps its name so a
reader finds the other side).  RegDem's decision (paper §3): for each
over-subscribed register, pick the spill tier (shared memory vs local
memory) and accept the access overhead that maximizes throughput via
occupancy.  The framework-level analogue decides, per hot kernel, where the
*cross-iteration working state* lives.  On Hopper the paper's own tiers are
literal again:

* ``RESIDENT_ON_CHIP``  the fused kernel keeps the state in registers and
                        shared memory across its inner loop (the attention
                        kernel's ``m / l / acc`` across KV tiles, the SSD
                        kernel's ``h`` across chunks) — the demotion;
* ``SPILL_HBM``         materialize it to HBM between ops (what the plain
                        PyTorch formulation does) — the local-memory spill;
* ``RECOMPUTE``         rematerialize in backward (remat policy) — nvcc's
                        "slower instruction sequences / zero spilling".

What was renamed from the reference, and why:

=========================  ==================================  =====================================
reference (TPU)            port (H100)                         why
=========================  ==================================  =====================================
``Residency.DEMOTE_VMEM``  ``Residency.RESIDENT_ON_CHIP``      the on-chip tier is registers + SMEM
``VMEM_BUDGET`` (64 MiB,   ``ON_CHIP_BUDGET`` (one block's     a block runs on one SM: its state
per core)                  registers + shared memory)          and operands must fit there
``attention_site(block_q,  ``attention_site`` sized by the     the kernel's own tile and footprint
block_kv)``                kernel's ``choose_tile`` plan       (``SMEM_PER_BLOCK`` and the
                                                               ``*_smem_bytes`` formulas)
``ssd_site`` (whole        ``ssd_site``: one block's share     the kernel's grid cuts ``h`` into
``(H, P, N)`` state)       ``(p_block, N)`` of it              ``H·P/p_block`` blocks
=========================  ==================================  =====================================

A site's ``state_bytes`` is what the kernel carries in registers (the
accumulator registers the kernel module counts, or ``m / l / acc`` of each
warp on the split path, or the SSD block's rows of ``h``); its
``operand_bytes`` is half the dynamic shared memory of the kernel's block, so
that :func:`plan_residency`'s double-buffered need (``state + 2 x operand``)
is the block's real on-chip footprint; ``steps`` counts the kernel's loop
iterations (KV tiles, 64-row chunks).

H100 SXM figures (NVIDIA, public): 65,536 32-bit registers per SM and at most
64 K per block, 255 per thread; 228 KB of shared memory per SM, of which a
block may take 227 KB.  Sources:
https://docs.nvidia.com/cuda/hopper-tuning-guide/index.html (shared memory,
register file) and
https://docs.nvidia.com/cuda/cuda-c-programming-guide/index.html#features-and-technical-specifications
(compute capability 9.0 limits).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import torch

from ..kernels import flash_attention as fa
from ..kernels import mamba2_ssd as ssd
from ..models import ModelConfig


class Residency(enum.Enum):
    RESIDENT_ON_CHIP = "resident_on_chip"
    SPILL_HBM = "spill_hbm"
    RECOMPUTE = "recompute"


#: bytes of one SM's register file (65,536 x 4), all of which one block may hold
REGISTER_FILE_BYTES = 65536 * 4
#: the on-chip budget of one block: the register file plus the shared memory a
#: block may take (the kernels' ``SMEM_PER_BLOCK``, 227 KB)
ON_CHIP_BUDGET = REGISTER_FILE_BYTES + fa.SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class Site:
    """One demotion site: a loop-carried working set in a hot kernel."""

    name: str
    #: bytes of carried state per grid step (the "registers" to demote)
    state_bytes: int
    #: bytes of the per-step operand working set
    operand_bytes: int
    #: HBM traffic incurred per step if the state is spilled instead
    spill_bytes_per_step: int
    steps: int


def _carried_bytes(plan: fa.Plan, dh: int) -> int:
    """Registers the attention block spends on its carried state, in bytes."""
    if plan.path == "mma":
        return fa.mma_accumulator_registers(dh, plan.bkv) * 4 * plan.threads
    if plan.path == "fma":
        return fa.accumulator_registers(dh, plan.bq, plan.bkv) * 4 * plan.threads
    # split: every warp carries its own partial m, l and acc of the block's rows
    return (2 * plan.bq + plan.bq * dh) * 4 * (plan.threads // 32)


def attention_site(cfg: ModelConfig, seq_q: int, seq_kv: int,
                   block_q: Optional[int] = None, block_kv: Optional[int] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Site:
    """The attention kernel's block at these lengths, as
    :func:`repro_torch.kernels.flash_attention.choose_tile` plans it for the
    model's head width and grouping (``block_q`` / ``block_kv`` override the
    tile, as there)."""
    dh = cfg.dh
    groups = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    plan = fa.choose_tile(seq_q, seq_kv, dh, block_q, block_kv, dtype=dtype, groups=groups)
    bq = plan.bq
    return Site(
        name="attention_accumulator",
        state_bytes=_carried_bytes(plan, dh),
        operand_bytes=fa.plan_smem_bytes(plan, dh, seq_kv) // 2,
        spill_bytes_per_step=bq * dh * 4 + 2 * bq * 4,   # partial o + stats
        steps=max(1, -(-seq_kv // plan.bkv)),
    )


def ssd_site(cfg: ModelConfig, seq: int, batch: int = 1,
             dtype: torch.dtype = torch.bfloat16) -> Site:
    """One block of the SSD kernel, as
    :func:`repro_torch.kernels.mamba2_ssd.choose_plan` plans it: its
    ``(p_block, N)`` rows of the float32 state, carried across the
    ``seq / CHUNK`` chunks it walks."""
    n = cfg.ssm_state
    plan = ssd.choose_plan(batch, cfg.ssm_heads, cfg.ssm_head_dim, n, dtype)
    state = plan.p_block * n * 4
    return Site(
        name="ssd_chunk_state",
        state_bytes=state,
        operand_bytes=plan.smem_bytes // 2,
        spill_bytes_per_step=state,
        steps=max(1, -(-seq // ssd.CHUNK)),
    )


def plan_residency(sites: List[Site], budget: int = ON_CHIP_BUDGET) -> Dict[str, Residency]:
    """Greedy demotion plan: keep state on chip while the double-buffered
    working set fits (eq.-1-style budget check); otherwise spill.  States
    that are cheap to recompute relative to their spill traffic recompute."""
    plan: Dict[str, Residency] = {}
    used = 0
    for site in sorted(sites, key=lambda s: -s.spill_bytes_per_step * s.steps):
        need = site.state_bytes + 2 * site.operand_bytes  # double-buffered
        if used + need <= budget:
            plan[site.name] = Residency.RESIDENT_ON_CHIP
            used += need
        elif site.state_bytes < site.spill_bytes_per_step // 2:
            plan[site.name] = Residency.RECOMPUTE
        else:
            plan[site.name] = Residency.SPILL_HBM
    return plan


def spilled_hbm_traffic(site: Site, residency: Residency) -> int:
    """Extra HBM bytes a site not kept on chip pays (feeds the memory term)."""
    if residency is Residency.RESIDENT_ON_CHIP:
        return 0
    if residency is Residency.SPILL_HBM:
        return site.spill_bytes_per_step * site.steps * 2  # write + read back
    return site.spill_bytes_per_step  # recompute: one final write

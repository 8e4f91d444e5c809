"""Maxwell (CC 5.2 / GM200) occupancy calculator.

Reproduces the CUDA Occupancy Calculator's step function [paper ref 23]:
occupancy cliffs occur at register-count boundaries, which is the entire
premise of RegDem (paper §1-2).  Validated in tests against the Table-1
benchmark points of the paper (e.g. cfd: 68 regs x 192 thr -> 0.375
theoretical; 56 regs -> 0.5625).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SMConfig:
    """Per-SM resource limits."""

    registers: int = 64 * 1024            # 32-bit registers per SM
    max_threads: int = 2048
    max_warps: int = 64
    max_blocks: int = 32
    smem_bytes: int = 96 * 1024            # GM200: 96 KB per SM
    smem_per_block: int = 48 * 1024        # max static+dynamic per block
    warp_size: int = 32
    reg_alloc_unit: int = 256              # registers, allocated per warp
    smem_alloc_unit: int = 256             # bytes
    max_regs_per_thread: int = 255
    num_sms: int = 24                      # GTX Titan X (GM200)


MAXWELL = SMConfig()


def _ceil_to(x: int, unit: int) -> int:
    return ((x + unit - 1) // unit) * unit


@dataclass(frozen=True)
class Occupancy:
    """Result of the calculator for one kernel configuration."""

    resident_blocks: int
    resident_warps: int
    resident_threads: int
    occupancy: float
    limiter: str  # "registers" | "smem" | "threads" | "blocks"

    def __float__(self) -> float:
        return self.occupancy


def occupancy(
    regs_per_thread: int,
    threads_per_block: int,
    smem_per_block: int = 0,
    sm: SMConfig = MAXWELL,
) -> Occupancy:
    """Theoretical occupancy of a kernel launch on one SM."""
    if threads_per_block <= 0 or threads_per_block > 1024:
        raise ValueError(f"bad threads_per_block={threads_per_block}")
    if regs_per_thread > sm.max_regs_per_thread:
        raise ValueError(f"regs_per_thread={regs_per_thread} exceeds ISA max")
    warps_per_block = math.ceil(threads_per_block / sm.warp_size)

    limits = {}
    # registers: allocated per warp with granularity reg_alloc_unit
    regs_per_warp = _ceil_to(max(regs_per_thread, 1) * sm.warp_size, sm.reg_alloc_unit)
    limits["registers"] = sm.registers // (regs_per_warp * warps_per_block)
    # shared memory
    if smem_per_block > sm.smem_per_block:
        raise ValueError("shared memory exceeds per-block limit")
    if smem_per_block > 0:
        limits["smem"] = sm.smem_bytes // _ceil_to(smem_per_block, sm.smem_alloc_unit)
    else:
        limits["smem"] = sm.max_blocks
    limits["threads"] = sm.max_threads // threads_per_block
    limits["blocks"] = sm.max_blocks
    # warp ceiling folds into the thread limit
    limits["threads"] = min(limits["threads"], sm.max_warps // warps_per_block)

    blocks = min(limits.values())
    limiter = min(limits, key=lambda k: limits[k])
    warps = blocks * warps_per_block
    return Occupancy(
        resident_blocks=blocks,
        resident_warps=warps,
        resident_threads=warps * sm.warp_size,
        occupancy=warps / sm.max_warps,
        limiter=limiter,
    )


def occupancy_of(kernel, sm: SMConfig | None = None) -> Occupancy:
    """Occupancy of a :class:`repro_torch.core.isa.Kernel` under its own
    architecture's SM limits (override with ``sm``)."""
    if sm is None:
        from repro_torch.arch import arch_of

        sm = arch_of(kernel).sm
    return occupancy(
        kernel.reg_count, kernel.threads_per_block, kernel.total_shared, sm
    )


def spill_targets(
    regs_per_thread: int,
    threads_per_block: int,
    smem_per_block: int,
    available_smem: int | None = None,
    sm: SMConfig = MAXWELL,
    bytes_per_slot: int = 4,
    reg_cost_per_word: float = 0.0,
    feasible=None,
) -> list[int]:
    """Register targets that land exactly on occupancy cliffs.

    This is RegDem's "automatic utility that chooses different register
    counts to spill such that different occupancy cliffs could be achieved
    and the spills can fit in the available shared memory" (paper §3).
    Returns candidate ``target_regs`` values in decreasing order, each the
    largest register count achieving a strictly higher occupancy level than
    the previous, floored at 32 registers (below which occupancy no longer
    improves — paper §3).

    The cost model is parameterized for the registered spill-strategy
    families (:mod:`repro_torch.core.strategies`):

    * ``bytes_per_slot`` — per-thread shared-memory bytes one demoted word
      occupies (4 = eq.-1 full words; 2 = compressed slots; 0 = a space
      whose slots are not charged against this block's allocation);
    * ``reg_cost_per_word`` — extra architectural registers each demoted
      word costs (warp-level resource sharing charges ``1/share``: the
      slot pool is register-file backed and shared by co-scheduled warps);
    * ``feasible`` — optional ``(spilled_words, Occupancy) -> bool`` veto
      for budgets outside the per-block charge (e.g. the per-SM scratchpad
      pool a cross-block carve draws from).

    Defaults reproduce the paper's shared-memory ladder exactly.
    """
    base = occupancy(max(regs_per_thread, 1), threads_per_block, smem_per_block, sm)
    targets: list[int] = []
    best = base.occupancy
    for regs in range(regs_per_thread - 1, 31, -1):
        # demoted registers consume shared memory themselves (eq. 1 layout);
        # the occupancy check must charge for it, or the "gain" is illusory.
        spilled = regs_per_thread - regs
        smem_needed = spilled * threads_per_block * bytes_per_slot
        budget = (
            available_smem
            if available_smem is not None
            else sm.smem_per_block - smem_per_block
        )
        if smem_needed > budget:
            break
        eff_regs = regs + math.ceil(spilled * reg_cost_per_word)
        if eff_regs >= regs_per_thread:
            continue
        occ = occupancy(eff_regs, threads_per_block, smem_per_block + smem_needed, sm)
        if feasible is not None and not feasible(spilled, occ):
            continue
        if occ.occupancy > best:
            targets.append(regs)
            best = occ.occupancy
    return targets

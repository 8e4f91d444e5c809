"""RegDem: register demotion to shared memory (paper §3, Fig. 3).

Given a scheduled kernel and a target register count, demote excess
registers to shared memory one at a time:

1. reserve a demoted-base-address register (RDA) and a demoted-value
   register (RDV) — "at least two registers must be added" (§3.2);
2. per candidate: rename every occurrence to RDV, insert ``LDS``/``STS``
   around uses/defs with barriers chosen by the *barrier tracker*
   (``GetBarrier``/``UpdateBarrierTracker`` in Fig. 3);
3. prune candidates with operand conflicts against the demoted register;
4. stop at the target, at 32 registers (no occupancy benefit below), or
   when candidates run out;
5. compact the register space (§3.3) and fix up stall counts.

Shared-memory layout (eq. 1): the r-th demoted word of thread ``t`` lives at
``t*4 + s + r*n*4`` (``s`` = static allocation rounded to bank alignment,
``n`` = threads/block), which is bank-conflict-free by construction.

:func:`demote` is a thin configuration of the unified pass pipeline
(:mod:`repro_torch.core.passes`): it binds a :class:`~repro_torch.core.spillspace.
SharedSpace` to :func:`repro_torch.core.passes.demotion_pipeline` and packages the
pipeline outcome as a :class:`RegDemResult`.  The demotion machinery itself
(barrier tracker, per-register transform, pass implementations) lives in
:mod:`repro_torch.core.passes`, shared with the §5.3 comparison variants.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .isa import Kernel
from .passes import (  # noqa: F401  (re-exported: historical home of these names)
    REG_FLOOR,
    BarrierTracker,
    PassContext,
    PassStat,
    RegDemOptions,
    choose_rdv_bank,
    demote_register,
    demotion_pipeline,
    stats_by_pass,
)
from .spillspace import SMEM_LIMIT, SharedSpace  # noqa: F401  (re-exported)


@dataclass
class RegDemResult:
    kernel: Kernel
    demoted: List[Tuple[int, int]]       # (original reg, width)
    demoted_words: int
    rdv: int
    rda: int
    target: int
    options: RegDemOptions
    reached_target: bool
    #: per-pass diagnostics/timings from the pipeline run, in order
    passes: List[PassStat] = field(default_factory=list)
    _rdv_wide: bool = False

    @property
    def demoted_count(self) -> int:
        """Register words moved to shared memory (paper Table 1, "# Registers
        Spilled / RegDem")."""
        return self.demoted_words

    def pass_stats(self) -> dict:
        """Per-pass stats keyed by pass name (re-runs suffixed ``#n``, see
        :func:`repro_torch.core.passes.stats_by_pass`)."""
        return stats_by_pass(self.passes)


def demote(
    kernel: Kernel,
    target_regs: int,
    options: Optional[RegDemOptions] = None,
    verify: str = "each",
    space=None,
    select=None,
    pipeline=None,
    observer=None,
) -> RegDemResult:
    """Run RegDem on ``kernel`` toward ``target_regs``; returns a new kernel.

    ``verify`` is the pipeline self-check policy (see
    :class:`repro_torch.core.passes.PassPipeline`); the default proves schedule
    validity and dataflow equivalence after every pass.

    The remaining keywords are the strategy-registry extension points
    (:mod:`repro_torch.core.strategies`): ``space`` overrides the
    :class:`~repro_torch.core.spillspace.SharedSpace` destination, ``select``
    overrides the candidate queue builder, ``pipeline`` replaces the
    standard :func:`~repro_torch.core.passes.demotion_pipeline` schedule (its own
    verify policy then applies), and ``observer`` is forwarded to
    :meth:`~repro_torch.core.passes.PassPipeline.run` (per-pass hooks for the
    prefix-invariant property tests).
    """
    options = options or RegDemOptions()
    ctx = PassContext(
        kernel,
        SharedSpace() if space is None else space,
        options,
        target=target_regs,
        select=select,
    )
    pipe = pipeline if pipeline is not None else demotion_pipeline(options, verify=verify)
    pipe.run(ctx, observer=observer)
    res = RegDemResult(
        kernel=ctx.kernel,
        demoted=ctx.demoted,
        demoted_words=ctx.demoted_words,
        rdv=ctx.rdv,
        rda=ctx.rda,
        target=target_regs,
        options=options,
        reached_target=ctx.kernel.reg_count <= ctx.floor,
        passes=ctx.passes,
    )
    res._rdv_wide = ctx.wide
    return res


# ---------------------------------------------------------------------------
# Driver: pick spill targets automatically (paper §3 "automatic utility")
# ---------------------------------------------------------------------------


def auto_targets(kernel: Kernel, max_targets: Optional[int] = None) -> List[int]:
    """Occupancy-cliff register targets for ``kernel`` under its own
    architecture's SM limits and spill budget, best-first.

    ``max_targets`` truncates the ladder (the autotuning search uses it to
    bound the variant space per kernel; ``None`` keeps every cliff)."""
    from repro_torch.arch import arch_of

    from .occupancy import spill_targets

    arch = arch_of(kernel)
    targets = spill_targets(
        kernel.reg_count,
        kernel.threads_per_block,
        kernel.shared_size,
        available_smem=arch.smem_spill_limit - kernel.shared_size,
        sm=arch.sm,
    )
    if max_targets is not None:
        targets = targets[:max_targets]
    return targets

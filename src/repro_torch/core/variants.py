"""Code-variant generation (paper Table 3 / §5.3).

Five variants of every benchmark kernel:

* ``nvcc``               the baseline: efficient scheduling, high register
                          count, no restriction;
* ``regdem``             this paper: demotion to shared memory at the
                          Table-1 target register count;
* ``local``              nvcc with ``--maxrregcount``: *aggressive register
                          allocation* — rematerialize what it can (slower
                          instruction sequences / "zero spilling") and spill
                          the rest to off-chip **local** memory;
* ``local-shared``       Hayes & Zhang [11]: the ``local`` variant at a
                          32-register target with its spill code converted to
                          shared memory (the closest research alternative);
* ``local-shared-relax`` the same conversion at RegDem's register target
                          (the enhanced research alternative).

The aggressive allocator mirrors nvcc's documented behaviour: it prefers
re-materialization over spilling (avoiding local-memory latency at the cost
of extra dynamic instructions), which is exactly the single-thread
performance loss the paper's §5.5 discussion attributes to the alternatives.

All five variants are instances of the unified pass pipeline
(:mod:`repro_torch.core.passes`): :func:`aggressive` binds
:func:`~repro_torch.core.passes.aggressive_pipeline` to a
:class:`~repro_torch.core.spillspace.LocalSpace` or
:class:`~repro_torch.core.spillspace.SharedSpace`, and ``regdem`` is
:func:`repro_torch.core.regdem.demote`'s demotion pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .isa import Kernel
from .kernelgen import Profile, generate
from .passes import PassContext, PassStat, RegDemOptions, aggressive_pipeline
from .regdem import REG_FLOOR, RegDemResult, demote
from .spillspace import LocalSpace, SpillSpace
from .spillspace import spill_space as make_space

VARIANT_NAMES = ("nvcc", "regdem", "local", "local-shared", "local-shared-relax")


@dataclass
class Variant:
    name: str
    kernel: Kernel
    #: registers spilled/demoted to memory (words)
    spilled: int = 0
    #: registers removed via rematerialization
    remat: int = 0
    #: RegDem result when applicable
    regdem: Optional[RegDemResult] = None
    #: per-pass diagnostics/timings from the generating pipeline
    passes: List[PassStat] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Aggressive register allocation (the nvcc --maxrregcount model)
# ---------------------------------------------------------------------------


def aggressive(
    kernel: Kernel,
    target_regs: int,
    spill_space: Union[str, SpillSpace] = "local",
    max_remat: Optional[int] = None,
    verify: str = "each",
) -> Variant:
    """Reduce register usage to ``target_regs`` the way nvcc does under
    ``--maxrregcount``: rematerialize first, then spill.

    ``spill_space='shared'`` converts the spill code to shared memory — the
    Hayes & Zhang local->shared transformation [11].  A
    :class:`~repro_torch.core.spillspace.SpillSpace` instance is also accepted.
    """
    if isinstance(spill_space, SpillSpace):
        space = spill_space
    elif spill_space == "shared":
        # the historical conversion never guarded the 48 KiB limit
        space = make_space("shared", check_limit=False)
    else:
        space = make_space(spill_space)

    opts = RegDemOptions(
        candidate_strategy="static",
        bank_avoid=False,
        elim_redundant=False,
        reschedule=False,
        substitute=False,
    )
    ctx = PassContext(
        kernel,
        space,
        opts,
        target=target_regs,
        floor=max(target_regs, 0),  # nvcc honours the raw target, not REG_FLOOR
        max_remat=max_remat,
    )
    aggressive_pipeline(verify=verify).run(ctx)
    name = "local" if isinstance(space, LocalSpace) else "local-shared"
    return Variant(
        name=name,
        kernel=ctx.kernel,
        spilled=ctx.demoted_words,
        remat=ctx.remat,
        passes=ctx.passes,
    )


# ---------------------------------------------------------------------------
# The Table-3 variant matrix
# ---------------------------------------------------------------------------


def make_variants(
    profile: Profile,
    regdem_options: Optional[RegDemOptions] = None,
    verify: str = "final",
    extra_strategies: Optional[List[str]] = None,
) -> Dict[str, Variant]:
    """Build all five §5.3 variants for one benchmark profile.

    ``verify`` is the pass-pipeline self-check policy.  Variant generation is
    the measurement hot path, so the default is ``"final"`` — the full
    schedule + dataflow check once per pipeline, after the last pass — which
    produces byte-identical kernels to ``"each"`` (regression-tested) at a
    fraction of the cost.  Pass ``"each"`` to fault-localize a broken pass.

    ``extra_strategies`` appends registry-built variants (one per named
    :mod:`repro_torch.core.strategies` strategy, probe options, best cliff
    target) to the paper's five.
    """
    return make_variants_for(
        generate(profile),
        profile.regdem_target,
        nvcc_spills=profile.nvcc_spills,
        regdem_options=regdem_options,
        verify=verify,
        extra_strategies=extra_strategies,
    )


def make_variants_for(
    base: Kernel,
    target: int,
    nvcc_spills: int = 0,
    regdem_options: Optional[RegDemOptions] = None,
    verify: str = "final",
    extra_strategies: Optional[List[str]] = None,
) -> Dict[str, Variant]:
    """The §5.3 variant matrix for a pre-built baseline kernel.

    :func:`make_variants` is this applied to a freshly generated Table-1
    profile; calling it directly lets the cross-arch benchmarks and the
    autotuning search build the same comparison set for a *retargeted*
    baseline (``repro_torch.arch.retarget``), whose arch tag every pipeline pass
    and the simulator then honour.
    """
    out: Dict[str, Variant] = {}
    out["nvcc"] = Variant(name="nvcc", kernel=base)

    rd = demote(base, target, regdem_options or RegDemOptions(), verify=verify)
    out["regdem"] = Variant(
        name="regdem", kernel=rd.kernel, spilled=rd.demoted_words, regdem=rd,
        passes=rd.passes,
    )

    # nvcc's remat capacity is bounded so that its local-spill count matches
    # the Table-1 "# Registers Spilled (nvcc)" column for this benchmark
    reduction = max(0, base.reg_count - target)
    cap = max(0, reduction - nvcc_spills)

    loc = aggressive(base, target, spill_space="local", max_remat=cap, verify=verify)
    loc.name = "local"
    out["local"] = loc

    ls = aggressive(base, REG_FLOOR, spill_space="shared", verify=verify)
    ls.name = "local-shared"
    out["local-shared"] = ls

    lsr = aggressive(base, target, spill_space="shared", max_remat=cap, verify=verify)
    lsr.name = "local-shared-relax"
    out["local-shared-relax"] = lsr

    # The Hayes & Zhang conversions are built unguarded (check_limit=False:
    # the historical transformation spills however much the register target
    # demands), so on kernels with large *static* shared memory the converted
    # spill arena can push total_shared past the per-block limit — such a
    # variant would fail to launch on real hardware, and downstream occupancy
    # math rightly refuses it.  Drop unlaunchable conversions from the
    # comparison set, exactly as a real experiment would have to.  RegDem
    # itself never needs this: its §3 target chooser only picks cliffs whose
    # spills fit (flushed by the real-workload corpus: 24 KiB kv-tile smem
    # x 256 threads overflows at the 32-register floor).
    from .spillspace import spill_limit

    for name in ("local-shared", "local-shared-relax"):
        if out[name].kernel.total_shared > spill_limit(out[name].kernel):
            del out[name]

    # registry-built extras: one variant per named strategy at its probe
    # combo and best cliff target (its own ladder; the paper target when
    # the ladder is empty)
    for name in extra_strategies or ():
        from repro_torch.arch import arch_of

        from .strategies import get_strategy

        strat = get_strategy(name)
        if strat.archs is not None and arch_of(base).name not in strat.archs:
            continue
        if not strat.select(base):
            continue
        targets = strat.targets(base, 1)
        tgt = targets[0] if targets else target
        res = strat.build(base, tgt, strat.option_combos(False)[0], verify=verify)
        out[name] = Variant(
            name=name,
            kernel=res.kernel,
            spilled=res.demoted_words,
            regdem=res,
            passes=res.passes,
        )
    return out

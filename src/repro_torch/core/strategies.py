"""The pluggable spill-strategy registry.

RegDem's gains come from *choosing* among spill-code variants (paper §5.3),
and the predictor-guided search automates the choice — but until this
module the choosable space was hardwired: three candidate orderings as a
string tuple (``repro_torch.core.candidates.STRATEGIES``) dispatched by
``if/elif``, one spill destination, one pass schedule.  A
:class:`Strategy` descriptor makes each point of that space a first-class
registered object:

* ``select``        the candidate-queue builder (ordering + filters);
* ``build``         the pass-pipeline factory: baseline kernel + register
                    target + option combo -> :class:`~repro_torch.core.regdem.
                    RegDemResult`;
* ``options_cls``   the per-strategy options dataclass (what used to be
                    flat :class:`~repro_torch.core.passes.RegDemOptions` knobs);
* ``option_combos`` the combos the search sweeps, probe combo first;
* ``options_label`` combo -> stable label suffix (cache keys, reports,
                    golden files);
* ``hints``         :class:`StrategyHints` the predictor uses to price a
                    demoted-slot access before anything is built;
* ``targets``       the per-strategy occupancy-cliff register ladder
                    (each family charges its own smem/register costs);
* ``archs``         optional arch allow-list (``None`` = every arch).

``candidates.make_candidates``, ``variants.make_variants_for``,
``SearchConfig``'s space enumeration, ``TranslationService.tune`` and the
benchmark harness all resolve strategies through :func:`get_strategy`, so
registering one new object widens every consumer at once.  The paper's
orderings (``static``/``cfg``/``conflict``) are registered under their
historical names with byte-identical candidate queues, option labels and
pipelines — existing cache keys, golden files and tuned containers stay
meaningful.

Three families from related work ship registered:

* ``warp_share``   warp-level register resource sharing (arXiv
  1503.05694): co-scheduled warps share a register-file-backed demoted-slot
  pool (``LDP``/``STP``, near-RF latency, zero shared-memory traffic);
  each warp is charged its pool share (``ceil(words/share)`` registers) by
  :class:`~repro_torch.core.passes.PoolAnchorPass`.
* ``block_share``  scratchpad sharing across thread blocks (arXiv
  1607.03238): spill slots carved from the *per-SM* scratchpad pool other
  resident blocks leave unused (:class:`~repro_torch.core.spillspace.
  CarveSpace`) — nothing lands in this block's own allocation, so the
  occupancy calculator never sees smem growth; a per-SM budget gates the
  demotion loop instead.
* ``compressed``   compressed spill slots (arXiv 2006.05693): spilled
  values packed to 2-byte slots (:class:`~repro_torch.core.spillspace.
  CompressedSpace`) — half the smem footprint per word, paid for with one
  ``PCK``/``UPCK`` ALU op around every demoted store/load; only width-1
  registers are candidates (pairs keep full-precision lanes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .candidates import order_candidates
from .passes import (
    CompactionPass,
    DemotionPass,
    Pass,
    PassPipeline,
    PoolAnchorPass,
    ProloguePass,
    RedundancyEliminationPass,
    RegDemOptions,
    ReserveRegistersPass,
    StallFixupPass,
)
from .regdem import RegDemResult, auto_targets, demote
from .spillspace import CarveSpace, CompressedSpace, WarpPoolSpace


# ---------------------------------------------------------------------------
# Per-strategy options dataclasses (satellite: knobs leave RegDemOptions)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PaperOptions:
    """The §3.4 knobs of the paper's candidate-ordering strategies."""

    bank_avoid: bool = True       # §3.4.1 RDV bank-conflict avoidance
    elim_redundant: bool = True   # §3.4.2 pass 1
    reschedule: bool = True       # §3.4.2 pass 2
    substitute: bool = True       # §3.4.2 pass 3

    def combo(self) -> Tuple[bool, bool, bool, bool]:
        return (self.bank_avoid, self.elim_redundant, self.reschedule, self.substitute)


@dataclass(frozen=True)
class WarpShareOptions:
    """Warp-level resource sharing (1503.05694) knobs."""

    share: int = 2                # co-scheduled warps sharing the slot pool
    elim_redundant: bool = True

    def combo(self) -> Tuple[int, bool]:
        return (self.share, self.elim_redundant)


@dataclass(frozen=True)
class BlockShareOptions(PaperOptions):
    """Cross-block scratchpad sharing (1607.03238) reuses the §3.4 knobs:
    the carve changes *where* slots live, not the demotion machinery."""


@dataclass(frozen=True)
class CompressedOptions:
    """Compressed spill slots (2006.05693) knobs.  Rescheduling and
    substitution are structurally off: the pack/unpack ops own the barrier
    protocol around every slot access."""

    bank_avoid: bool = True
    elim_redundant: bool = True

    def combo(self) -> Tuple[bool, bool]:
        return (self.bank_avoid, self.elim_redundant)


# ---------------------------------------------------------------------------
# The descriptor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StrategyHints:
    """Predictor cost priors for one strategy, readable before any variant
    is built (:func:`repro_torch.core.predictor.strategy_access_cost` prices a
    demoted-slot access from these; the search uses that price to break
    exact predictor ties toward the cheaper access path)."""

    #: per-thread shared-memory bytes one demoted word occupies in *this
    #: block's* allocation (4 = eq.-1 full word, 2 = compressed, 0 = not
    #: charged here)
    smem_bytes_per_word: int = 4
    #: architectural registers one demoted word costs (warp pools charge
    #: ``1/share``; everything else 0)
    reg_cost_per_word: float = 0.0
    #: extra fixed-latency ALU ops per demoted access (pack/unpack)
    access_overhead: int = 0
    #: :class:`repro_torch.arch.registry.LatencyModel` attribute of the slot
    #: access path ("shared", "misc", "local", ...)
    latency_class: str = "shared"


@dataclass(frozen=True)
class Strategy:
    """One registered spill strategy (see module docstring for fields)."""

    name: str
    doc: str
    #: grouping for reports/histograms: "paper" for the §3.4.3 orderings,
    #: the family name itself for the related-work strategies
    family: str
    options_cls: type
    hints: StrategyHints
    #: Kernel -> ordered demotion queue [(leading_reg, width)]
    select: Callable[[object], List[Tuple[int, int]]]
    #: full_options -> option combos (tuples of primitives, probe first)
    option_combos: Callable[[bool], List[tuple]]
    #: combo -> stable label suffix, "<name>:<combo-encoding>"
    options_label: Callable[[tuple], str]
    #: (base, target, combo, verify=..., observer=...) -> RegDemResult
    build: Callable[..., RegDemResult]
    #: (base, max_targets) -> occupancy-cliff register ladder
    targets: Callable[[object, Optional[int]], List[int]]
    #: arch allow-list (canonical registry names); None = every arch
    archs: Optional[Tuple[str, ...]] = None


_REGISTRY: Dict[str, Strategy] = {}


def register_strategy(strategy: Strategy) -> Strategy:
    """Register ``strategy`` under its name; returns it.  Duplicate names
    are an error — strategies are identity-by-name everywhere (labels,
    cache keys, golden files), so silent replacement would corrupt all of
    them."""
    if strategy.name in _REGISTRY:
        raise ValueError(f"strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> Strategy:
    """Resolve a strategy by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def strategy_names() -> List[str]:
    """Registered strategy names, in registration order (the paper's three
    first — the order the default search space enumerates)."""
    return list(_REGISTRY)


def strategies() -> List[Strategy]:
    """Registered strategies, in registration order."""
    return list(_REGISTRY.values())


# ---------------------------------------------------------------------------
# The paper's candidate-ordering strategies (§3.4.3), registered under
# their historical names with byte-identical behaviour
# ---------------------------------------------------------------------------


def _paper_combos(full: bool) -> List[Tuple[bool, bool, bool, bool]]:
    """The historical option grid: grouped Fig.-7 dimensions by default
    (bank avoidance x enhancement passes), all 2^4 flags when ``full``.
    Probe combo (all-on) first."""
    if full:
        return [
            (b, e, r, s)
            for b in (True, False)
            for e in (True, False)
            for r in (True, False)
            for s in (True, False)
        ]
    return [(b, e, e, e) for b in (True, False) for e in (True, False)]


def _bits(flags: tuple) -> str:
    return "".join("1" if f else "0" for f in flags)


def _paper_regdem_options(ordering: str, combo: tuple) -> RegDemOptions:
    bank, elim, resched, subst = combo
    return RegDemOptions(
        candidate_strategy=ordering,
        bank_avoid=bank,
        elim_redundant=elim,
        reschedule=resched,
        substitute=subst,
    )


def _register_paper(name: str, doc: str) -> Strategy:
    def select(kernel):
        return order_candidates(kernel, name)

    def label(combo: tuple) -> str:
        # byte-identical to RegDemOptions.label() — pinned by the
        # signature-stability tests
        return f"{name}:{_bits(combo)}"

    def build(base, target, combo, verify: str = "each", observer=None):
        opts = _paper_regdem_options(name, combo)
        return demote(base, target, opts, verify=verify, observer=observer)

    def targets(base, max_targets=None):
        return auto_targets(base, max_targets=max_targets)

    return register_strategy(
        Strategy(
            name=name,
            doc=doc,
            family="paper",
            options_cls=PaperOptions,
            hints=StrategyHints(),
            select=select,
            option_combos=_paper_combos,
            options_label=label,
            build=build,
            targets=targets,
        )
    )


_register_paper("static", "ascending static access count (§3.4.3)")
_register_paper("cfg", "CFG-weighted access count, loops x10 (§3.4.3)")
_register_paper("conflict", "ascending operand-conflict degree (§3.4.3)")


# ---------------------------------------------------------------------------
# warp_share — warp-level register resource sharing (arXiv 1503.05694)
# ---------------------------------------------------------------------------


def _warp_share_combos(full: bool) -> List[Tuple[int, bool]]:
    return [(2, True), (4, True), (2, False), (4, False)]


def _warp_share_label(combo: tuple) -> str:
    share, elim = combo
    return f"warp_share:s{share}e{int(elim)}"


def _warp_share_build(base, target, combo, verify: str = "each", observer=None):
    share, elim = combo
    opts = RegDemOptions(
        candidate_strategy="cfg",
        bank_avoid=True,
        elim_redundant=elim,
        reschedule=False,
        substitute=False,
    )
    passes: List[Pass] = [
        ReserveRegistersPass(bank_tune=True),
        ProloguePass(),
        DemotionPass(),
    ]
    if elim:
        passes.append(RedundancyEliminationPass())
    passes += [CompactionPass(), PoolAnchorPass(share), StallFixupPass()]
    return demote(
        base,
        target,
        opts,
        space=WarpPoolSpace(share),
        pipeline=PassPipeline(passes, verify=verify),
        observer=observer,
    )


def _warp_share_targets(base, max_targets=None):
    from repro_torch.arch import arch_of

    from .occupancy import spill_targets

    # slots are register-file backed: zero smem per word, but each word
    # costs 1/share registers (the probe share of 2) — the ladder only
    # keeps cliffs that survive that charge
    targets = spill_targets(
        base.reg_count,
        base.threads_per_block,
        base.shared_size,
        sm=arch_of(base).sm,
        bytes_per_slot=0,
        reg_cost_per_word=0.5,
    )
    return targets if max_targets is None else targets[:max_targets]


register_strategy(
    Strategy(
        name="warp_share",
        doc="warp-level register resource sharing (arXiv 1503.05694)",
        family="warp_share",
        options_cls=WarpShareOptions,
        hints=StrategyHints(
            smem_bytes_per_word=0,
            reg_cost_per_word=0.5,
            access_overhead=0,
            latency_class="misc",
        ),
        select=lambda kernel: order_candidates(kernel, "cfg"),
        option_combos=_warp_share_combos,
        options_label=_warp_share_label,
        build=_warp_share_build,
        targets=_warp_share_targets,
    )
)


# ---------------------------------------------------------------------------
# block_share — scratchpad sharing across thread blocks (arXiv 1607.03238)
# ---------------------------------------------------------------------------


def _block_share_build(base, target, combo, verify: str = "each", observer=None):
    opts = _paper_regdem_options("cfg", combo)
    return demote(
        base, target, opts, verify=verify, space=CarveSpace(), observer=observer
    )


def _block_share_targets(base, max_targets=None):
    from repro_torch.arch import arch_of

    from .occupancy import _ceil_to, spill_targets

    sm = arch_of(base).sm
    static = _ceil_to(base.shared_size, sm.smem_alloc_unit) if base.shared_size else 0

    def feasible(spilled: int, occ) -> bool:
        # every resident block needs its carve from the per-SM pool,
        # alongside every block's static allocation (1607.03238's budget)
        carve = spilled * base.threads_per_block * 4
        return occ.resident_blocks * (static + carve) <= sm.smem_bytes

    targets = spill_targets(
        base.reg_count,
        base.threads_per_block,
        base.shared_size,
        sm=sm,
        bytes_per_slot=0,       # nothing lands in this block's allocation
        feasible=feasible,
    )
    return targets if max_targets is None else targets[:max_targets]


register_strategy(
    Strategy(
        name="block_share",
        doc="cross-thread-block scratchpad sharing (arXiv 1607.03238)",
        family="block_share",
        options_cls=BlockShareOptions,
        hints=StrategyHints(
            smem_bytes_per_word=0,
            reg_cost_per_word=0.0,
            access_overhead=0,
            latency_class="shared",
        ),
        select=lambda kernel: order_candidates(kernel, "cfg"),
        option_combos=_paper_combos,
        options_label=lambda combo: f"block_share:{_bits(combo)}",
        build=_block_share_build,
        targets=_block_share_targets,
    )
)


# ---------------------------------------------------------------------------
# compressed — compressed spill slots (arXiv 2006.05693)
# ---------------------------------------------------------------------------


def _compressed_select(kernel) -> List[Tuple[int, int]]:
    # only width-1 registers compress (pairs keep full-precision lanes)
    return [(r, w) for r, w in order_candidates(kernel, "static") if w == 1]


def _compressed_combos(full: bool) -> List[Tuple[bool, bool]]:
    return [(True, True), (False, True), (True, False), (False, False)]


def _compressed_build(base, target, combo, verify: str = "each", observer=None):
    bank, elim = combo
    opts = RegDemOptions(
        candidate_strategy="static",
        bank_avoid=bank,
        elim_redundant=elim,
        reschedule=False,
        substitute=False,
    )
    return demote(
        base,
        target,
        opts,
        verify=verify,
        space=CompressedSpace(),
        select=_compressed_select,
        observer=observer,
    )


def _compressed_targets(base, max_targets=None):
    from repro_torch.arch import arch_of

    from .occupancy import spill_targets

    arch = arch_of(base)
    targets = spill_targets(
        base.reg_count,
        base.threads_per_block,
        base.shared_size,
        available_smem=arch.smem_spill_limit - base.shared_size,
        sm=arch.sm,
        bytes_per_slot=CompressedSpace.SLOT_BYTES,
    )
    return targets if max_targets is None else targets[:max_targets]


register_strategy(
    Strategy(
        name="compressed",
        doc="compressed spill slots via static value compression (arXiv 2006.05693)",
        family="compressed",
        options_cls=CompressedOptions,
        hints=StrategyHints(
            smem_bytes_per_word=CompressedSpace.SLOT_BYTES,
            reg_cost_per_word=0.0,
            access_overhead=1,
            latency_class="shared",
        ),
        select=_compressed_select,
        option_combos=_compressed_combos,
        options_label=lambda combo: f"compressed:{_bits(combo)}",
        build=_compressed_build,
        targets=_compressed_targets,
    )
)

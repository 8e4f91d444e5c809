"""Predictor-guided parallel autotuning search over the RegDem variant space.

The paper's pipeline is "generate variants, let the compile-time predictor
pick one" (§4-§5) over a fixed, hand-picked variant set.  This module
searches the much larger space the machinery already supports:

* every registered :mod:`repro_torch.core.strategies` strategy — the paper's
  candidate orderings (``static``/``cfg``/``conflict``) plus the
  related-work families (``warp_share``/``block_share``/``compressed``),
* each strategy's own occupancy-cliff target ladder and option combos,
* every registered :mod:`repro_torch.arch` backend the kernel can retarget to.

Exhaustively simulating that space is what the predictor exists to avoid, so
the search is staged:

1. **enumerate** the space (cheap descriptors, nothing built yet);
2. **beam** — build one probe variant per (arch, target, strategy) and score
   it with the compile-time predictor (:func:`~repro_torch.core.predictor.
   estimate_stalls` + occupancy, eq. 2/3 — no simulation), keeping the
   ``beam_width`` best;
3. **expand** the option knobs for beam survivors only, predictor-scored the
   same way;
4. **confirm** the global ``top_k`` (plus every ``nvcc`` baseline and any
   caller-supplied anchor variants) on the event-driven simulator through
   :class:`~repro_torch.core.simcache.SimCache`, and ship the variant with the
   fewest simulated cycles.

Stages 2-4 fan out over a **deterministic process pool**: tasks are pure
functions of their payload, submitted and joined in enumeration order, each
worker process is seeded once from ``config.seed`` at startup (hygiene —
the tasks themselves never draw randomness, and the caller's in-process
RNG state is never touched), and each task measures into a private
:class:`SimCache` whose entries are merged into the parent cache on
join (first writer wins) — so the result, the report, and the final cache
contents are identical for 1 worker and N workers.  ``workers`` is therefore
deliberately **not** part of :meth:`SearchConfig.signature`, and repeated
tuning of the same content is a pure :class:`~repro_torch.core.translator.
TranslationCache` hit.

``SEARCH_TOLERANCE`` documents the contract the differential tests hold the
beam to: the chosen variant's simulated cycles stay within 5% of the
exhaustive simulate-everything optimum (the predictor's §5 accuracy claim —
the paper reaches 99% of oracle performance — leaves that much room for
pruning error).
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.obs.stallprof import StallProfile

from .candidates import STRATEGIES, spillable  # noqa: F401  (STRATEGIES re-exported)
from .isa import Kernel
from .predictor import achieved_occupancy, f_occupancy, ranking_agreement
from .simcache import DEFAULT_SIM_CACHE, SimCache
from .strategies import get_strategy, strategy_names
from .workerpool import Quarantined, WorkerCrashError, supervised_map

#: Relative simulated-cycle slack the beam search is allowed vs exhaustive
#: ground truth (pinned by the differential tests).
SEARCH_TOLERANCE = 0.05


@dataclass(frozen=True)
class SearchConfig:
    """Knobs of the autotuning search.

    Everything except ``workers`` is part of :meth:`signature` (the
    translation-cache key): the pool size affects wall time only, never the
    result — pinned by the determinism property test.
    """

    #: registered strategy names to probe (:mod:`repro_torch.core.strategies`);
    #: ``None`` = every registered strategy, in registration order
    strategies: Optional[Tuple[str, ...]] = None
    #: arch registry names to retarget to; ``None`` = every registered arch
    archs: Optional[Tuple[str, ...]] = None
    #: truncate the auto_targets ladder per arch (None = every cliff)
    max_targets: Optional[int] = None
    #: sweep all 2^4 option-flag combinations per beam survivor instead of
    #: the grouped Fig.-7 dimensions (bank avoidance x enhancements)
    full_options: bool = False
    #: (arch, target, strategy) probes kept after predictor scoring
    beam_width: int = 6
    #: variants confirmed on the simulator (baselines/anchors ride free)
    top_k: int = 4
    #: process-pool size; <=1 runs in-process (identical results either way)
    workers: int = 0
    #: pool-worker RNG seed (hygiene only: no task draws randomness)
    seed: int = 0
    #: pass-pipeline self-check policy.  The default ``"chosen"`` builds
    #: variants unchecked and verifies only the winning kernel (schedule +
    #: dataflow equivalence vs its arch baseline) once, after selection —
    #: what ships is always verified, and the N-1 losing pipeline runs skip
    #: the oracle.  Any :class:`~repro_torch.core.passes.PassPipeline` policy
    #: (``"each"``/``"schedule"``/``"final"``/``"none"``) applies to every
    #: variant instead.
    verify: str = "chosen"
    #: attribute stall cycles per instruction/reason for every confirmed
    #: variant (:attr:`SearchReport.stall_profiles`) — extra profiled
    #: simulator runs, so off by default
    profile: bool = False

    def signature(self) -> tuple:
        """Everything that determines the search *result* (cache key).

        ``workers`` and ``seed`` are deliberately absent: neither changes
        the outcome (the tasks are pure and never draw randomness), so
        tuning the same content under a different pool size or seed must be
        a cache hit, not a re-search.  An explicit ``strategies`` tuple
        signs as itself — byte-identical to the pre-registry signatures for
        the paper's names (pinned by the signature-stability test);
        ``None`` resolves to the registered names, so registering a new
        strategy correctly invalidates default-config tunes."""
        return (
            tuple(strategy_names()) if self.strategies is None else tuple(self.strategies),
            None if self.archs is None else tuple(self.archs),
            self.max_targets,
            self.full_options,
            self.beam_width,
            self.top_k,
            self.verify,
            self.profile,
        )


@dataclass
class ScoredVariant:
    """One predictor-scored point of the search space."""

    label: str
    arch: str
    #: demotion register target (None for baselines/anchors)
    target: Optional[int]
    #: RegDemOptions label (None for baselines/anchors)
    options: Optional[str]
    regs: int
    demoted_words: int
    occupancy: float
    #: raw whole-program stall estimate at ``occupancy`` (eq. 2)
    stalls: float
    #: eq.-3 adjusted estimate, comparable within one architecture
    adjusted: float = 0.0
    #: predicted cost relative to the same arch's ``nvcc`` baseline — the
    #: ranking metric.  Cycle and stall counts of different architectures
    #: are different units (Volta's latency model roughly halves Maxwell's
    #: cycle counts for the same program), so the search compares variants
    #: by how much they beat *their own* arch's do-nothing option.
    rel: float = 1.0
    #: search stage that produced it: baseline | beam | expand | anchor
    stage: str = "beam"
    #: simulated cycles, filled for confirmed variants only
    cycles: Optional[int] = None

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "arch": self.arch,
            "target": self.target,
            "options": self.options,
            "regs": self.regs,
            "demoted_words": self.demoted_words,
            "occupancy": round(self.occupancy, 6),
            "stalls": round(self.stalls, 3),
            "adjusted": round(self.adjusted, 3),
            "rel": round(self.rel, 6),
            "stage": self.stage,
            "cycles": self.cycles,
        }


@dataclass
class SearchReport:
    """Everything one kernel's search did and found.

    :meth:`to_json` is deterministic (wall-clock time excluded), which is
    what lets a tuned container embed the report as a ``.note`` section and
    still be byte-identical across repeat runs.
    """

    kernel_name: str
    input_arch: str
    chosen: str
    #: what the predictor alone would have shipped (argmin adjusted)
    predictor_choice: str
    #: the do-nothing option, always confirmed
    baseline: str
    #: enumerable size of the widened space (demotions + baselines)
    space_size: int
    #: demotion pipelines actually run (beam + expand)
    explored: int
    #: variants confirmed on the simulator
    simulated: int
    beam: List[str] = field(default_factory=list)
    #: predictor-vs-simulator ranking agreement over the confirmed set
    #: (orderings compared on baseline-relative cost)
    agreement: float = 1.0
    variants: List[ScoredVariant] = field(default_factory=list)
    #: label -> simulated cycles for every confirmed variant
    cycles: Dict[str, int] = field(default_factory=dict)
    #: simulated speedup of the chosen variant over its arch's baseline
    speedup: float = 1.0
    #: best confirmed variant per architecture
    per_arch: Dict[str, str] = field(default_factory=dict)
    #: label -> stall-attribution profile for every confirmed variant
    #: (populated when :attr:`SearchConfig.profile` is set; deterministic,
    #: so profiled reports stay byte-identical across repeat runs)
    stall_profiles: Dict[str, StallProfile] = field(default_factory=dict)
    seconds: float = 0.0
    #: raw :meth:`to_json` dict stashed by :meth:`from_json`.  A report
    #: warm-loaded from the artifact store does not reconstruct
    #: ``stall_profiles`` as objects, yet its container ``.note`` sections
    #: must stay byte-identical to the original — so re-serialization
    #: returns the stash verbatim.
    _raw: Optional[dict] = field(default=None, repr=False, compare=False)

    def to_json(self) -> dict:
        if self._raw is not None:
            return copy.deepcopy(self._raw)
        return {
            "kernel": self.kernel_name,
            "input_arch": self.input_arch,
            "chosen": self.chosen,
            "predictor_choice": self.predictor_choice,
            "baseline": self.baseline,
            "space_size": self.space_size,
            "explored": self.explored,
            "simulated": self.simulated,
            "beam": list(self.beam),
            "agreement": round(self.agreement, 4),
            "speedup": round(self.speedup, 4),
            "per_arch": dict(sorted(self.per_arch.items())),
            "cycles": dict(sorted(self.cycles.items())),
            "stall_profiles": {
                lb: p.to_json() for lb, p in sorted(self.stall_profiles.items())
            },
            "variants": [v.to_json() for v in self.variants],
        }

    @classmethod
    def from_json(cls, data: dict) -> "SearchReport":
        """Rebuild a report from its :meth:`to_json` dict (disk warm-load).

        Variants round-trip exactly (``to_json`` keys are the field names);
        stall profiles stay raw-JSON-only — :meth:`to_json` returns the
        stashed original, so a warm-loaded container re-serializes
        byte-identically."""
        rep = cls(
            kernel_name=data["kernel"],
            input_arch=data["input_arch"],
            chosen=data["chosen"],
            predictor_choice=data["predictor_choice"],
            baseline=data["baseline"],
            space_size=data["space_size"],
            explored=data["explored"],
            simulated=data["simulated"],
            beam=list(data.get("beam", [])),
            agreement=data.get("agreement", 1.0),
            variants=[ScoredVariant(**v) for v in data.get("variants", [])],
            cycles={k: int(v) for k, v in data.get("cycles", {}).items()},
            speedup=data.get("speedup", 1.0),
            per_arch=dict(data.get("per_arch", {})),
        )
        rep._raw = copy.deepcopy(data)
        return rep


@dataclass
class SearchOutcome:
    """The winning kernel plus the full search report."""

    kernel: Kernel
    report: SearchReport
    #: variant labels dropped because their pool task repeatedly crashed
    #: its worker (see :mod:`repro_torch.core.workerpool`).  Non-empty means the
    #: outcome is *not* the fault-free search result — the translation
    #: service refuses to cache or serve it (the daemon degrades instead).
    quarantined: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Pure worker tasks (module-level: picklable under fork and spawn)
# ---------------------------------------------------------------------------


def _task_obs_begin(tel: tuple) -> tuple:
    """Worker-side telemetry entry: honour the parent's on/off switch and
    mark the event prefix a fork inherits, so only task-added spans export.

    The per-task registry clear keeps metric accounting exact: the fork
    snapshot (and any earlier task's already-exported observations in a
    reused worker process) must never export twice."""
    parent_pid, enabled = tel
    t = obs.get_telemetry()
    if enabled:
        if os.getpid() != parent_pid:
            t.registry.clear()
        t.enabled = True
    return parent_pid, t.event_count()


def _task_obs_end(tel_state: tuple) -> tuple:
    """Worker-side telemetry exit: ``(span_records, metrics_export)`` for
    the parent's :meth:`Telemetry.adopt` / :meth:`MetricsRegistry.merge`.
    Empty when the task ran in-process (spans already landed in the parent
    timeline directly) or telemetry is off."""
    parent_pid, mark = tel_state
    t = obs.get_telemetry()
    if os.getpid() == parent_pid or not t.enabled:
        return (), {}
    return tuple(t.export_events(mark)), t.registry.export()


def _build_variant(base, target, strategy, combo, verify, cache):
    """Build + predictor-score one demotion variant.

    Pure function of its inputs — the in-process stage loop and the pool
    task (:func:`_expand_one`) both run exactly this, so pool size can
    never change a result.  ``strategy`` is a registry name and ``combo``
    one of its option combos (primitives only: picklable either way).
    Returns ``(RegDemResult, occupancy, stalls)`` with the stall estimate
    measured through ``cache``.
    """
    res = get_strategy(strategy).build(base, target, combo, verify=verify)
    occ = achieved_occupancy(res.kernel)
    stalls = cache.estimate_stalls(res.kernel, occ)
    return res, occ, stalls


def _expand_one(payload: tuple) -> tuple:
    """Pool-worker wrapper of :func:`_build_variant`: deserialize the base,
    build + score into a private cache, ship everything back picklable.
    Returns ``(index, kernel_blob, regs, demoted_words, occupancy,
    raw_stalls, cache_export, obs_export)``.
    """
    (index, base_blob, target, strategy, combo, verify, tel) = payload
    from repro_torch.binary import container

    tel_state = _task_obs_begin(tel)
    with obs.span("search.variant", index=index, target=target):
        base = container.loads(base_blob)
        cache = SimCache()
        res, occ, stalls = _build_variant(base, target, strategy, combo, verify, cache)
    return (
        index,
        container.dumps(res.kernel),
        res.kernel.reg_count,
        res.demoted_words,
        occ,
        stalls,
        cache.export(),
        _task_obs_end(tel_state),
    )


def _simulate_one(payload: tuple) -> tuple:
    """Simulate (and optionally stall-profile) one confirmed variant;
    returns ``(index, SimResult, cache_export, obs_export)`` — the profile
    rides home inside the cache export's ``profiles`` table."""
    (index, blob, profile, tel) = payload
    from repro_torch.binary import container

    tel_state = _task_obs_begin(tel)
    with obs.span("search.confirm_sim", index=index):
        kernel = container.loads(blob)
        cache = SimCache()
        if profile:
            cache.profile(kernel)
        res = cache.simulate(kernel)
    return index, res, cache.export(), _task_obs_end(tel_state)


def _pool_map(fn, payloads: Sequence[tuple], workers: int, seed: int = 0) -> list:
    """Run ``fn`` over ``payloads`` with deterministic result ordering.

    ``workers <= 1`` (or a single payload) runs in-process through the very
    same task functions, so pool size can never change a result — only
    completion time.  Results come back in submission order regardless of
    which worker finished first.

    The pool is **supervised** (:func:`repro_torch.core.workerpool.
    supervised_map`): a crashed worker is restarted and its task retried;
    a task that repeatedly kills its worker comes back as a
    :class:`~repro_torch.core.workerpool.Quarantined` marker instead of hanging
    or failing the whole search — the stage loops drop that variant and
    record it in :attr:`SearchOutcome.quarantined`.
    """
    return supervised_map(fn, payloads, workers, seed=seed)


# ---------------------------------------------------------------------------
# The search driver
# ---------------------------------------------------------------------------


def _flag_combos(full: bool) -> List[Tuple[bool, bool, bool, bool]]:
    """Option-knob combinations, probe (all-on) first.

    Grouped mode is the Fig.-7 ablation grid: bank-conflict avoidance x
    the §3.4.2 enhancement passes as one dimension.  ``full`` sweeps all
    2^4 flag combinations (the paper's exhaustive search).
    """
    if full:
        combos = [
            (b, e, r, s)
            for b in (True, False)
            for e in (True, False)
            for r in (True, False)
            for s in (True, False)
        ]
    else:
        combos = [(b, e, e, e) for b in (True, False) for e in (True, False)]
    return combos


def _resolve_archs(kernel: Kernel, config: SearchConfig) -> List[str]:
    """Canonical arch names to search, input arch first, rest sorted."""
    from repro_torch.arch import arch_names, arch_of, get_arch

    own = arch_of(kernel).name
    if config.archs is None:
        names = set(arch_names())
    else:
        names = {get_arch(a).name for a in config.archs}
    rest = sorted(n for n in names if n != own)
    return ([own] if own in names else []) + rest


def search(
    kernel: Kernel,
    config: Optional[SearchConfig] = None,
    extra_variants: Optional[Dict[str, Kernel]] = None,
    cache: Optional[SimCache] = None,
) -> SearchOutcome:
    """Autotune one kernel over the widened variant space.

    ``extra_variants`` (label -> kernel) are *anchors*: always confirmed on
    the simulator alongside the searched top-k, so the winner is guaranteed
    no worse than any of them (the benchmark harness anchors the fixed §5.3
    variant set this way).  ``cache`` defaults to the process-wide
    :data:`~repro_torch.core.simcache.DEFAULT_SIM_CACHE`.
    """
    config = config or SearchConfig()
    with obs.span("search", kernel=kernel.name, workers=config.workers):
        return _search_impl(kernel, config, extra_variants, cache)


def _adopt_obs(obs_export: tuple) -> None:
    """Merge one pool task's telemetry into the parent timeline/registry
    (called in submission order — histogram replay order is deterministic)."""
    spans, metric_export = obs_export
    if spans:
        obs.get_telemetry().adopt(list(spans))
    if metric_export:
        obs.metrics().merge(metric_export)


def _search_impl(
    kernel: Kernel,
    config: SearchConfig,
    extra_variants: Optional[Dict[str, Kernel]],
    cache: Optional[SimCache],
) -> SearchOutcome:
    from repro_torch.arch import arch_of, retarget
    from repro_torch.binary import container

    cache = cache if cache is not None else DEFAULT_SIM_CACHE
    #: rides in every pool payload: workers mirror the parent's telemetry
    #: switch and ship their spans/metrics back on join
    tel = (os.getpid(), obs.enabled())
    t0 = time.perf_counter()

    own = arch_of(kernel).name
    archs = _resolve_archs(kernel, config)
    # the do-nothing option is always on the table, even when the caller
    # restricted the search to foreign archs
    base_archs = archs if own in archs else [own] + archs

    bases: Dict[str, Kernel] = {}
    blobs: Dict[str, bytes] = {}
    for arch in base_archs:
        base = kernel if arch == own else retarget(kernel, arch)
        bases[arch] = base
        blobs[arch] = container.dumps(base)

    strategy_list = [
        get_strategy(s)
        for s in (strategy_names() if config.strategies is None else config.strategies)
    ]
    scored: Dict[str, ScoredVariant] = {}
    kernels: Dict[str, Kernel] = {}

    # -- baselines (scored in-process: no pipeline to run) --------------------
    for arch in base_archs:
        base = bases[arch]
        label = f"{arch}/nvcc"
        occ = achieved_occupancy(base)
        scored[label] = ScoredVariant(
            label=label,
            arch=arch,
            target=None,
            options=None,
            regs=base.reg_count,
            demoted_words=0,
            occupancy=occ,
            stalls=cache.estimate_stalls(base, occ),
            stage="baseline",
        )
        kernels[label] = base

    # -- stage 1: enumerate + probe (one probe-combo demotion per
    #    (arch, strategy, target)) ---------------------------------------------
    specs: List[Tuple[str, int, str, tuple]] = []
    space_size = len(base_archs)  # the baselines
    for arch in archs:
        base = bases[arch]
        if not spillable(base):
            continue
        for strat in strategy_list:
            if strat.archs is not None and arch not in strat.archs:
                continue
            if not strat.select(base):
                # strategy-specific candidate filter left nothing to demote
                continue
            targets = strat.targets(base, config.max_targets)
            combos = strat.option_combos(config.full_options)
            space_size += len(targets) * len(combos)
            for tgt in targets:
                specs.append((arch, tgt, strat.name, combos[0]))

    #: the pipeline self-check each variant build runs ("chosen" defers
    #: all verification to the single post-selection winner check)
    pipeline_verify = "none" if config.verify == "chosen" else config.verify

    #: variant labels dropped because their pool task repeatedly crashed
    #: its worker — reported on the outcome so callers can refuse to treat
    #: a narrowed search as the fault-free result
    quarantined_labels: List[str] = []

    def quarantine(label: str) -> None:
        quarantined_labels.append(label)
        if obs.enabled():
            obs.metrics().counter("search.quarantined").inc()

    def run_stage(stage_specs, stage_name):
        in_process = config.workers <= 1 or len(stage_specs) <= 1
        # (kernel, regs, demoted_words, occupancy, stalls) — or None for a
        # spec whose pool task was quarantined
        rows = []
        with obs.span(f"search.{stage_name}", variants=len(stage_specs)):
            if in_process:
                # the pool task's exact work minus its container round-trips,
                # measured straight into the parent cache
                for i, (arch, tgt, strat, flags) in enumerate(stage_specs):
                    with obs.span("search.variant", index=i, target=tgt):
                        res, occ, stalls = _build_variant(
                            bases[arch], tgt, strat, flags, pipeline_verify, cache
                        )
                    rows.append(
                        (res.kernel, res.kernel.reg_count, res.demoted_words,
                         occ, stalls)
                    )
            else:
                payloads = [
                    (i, blobs[arch], tgt, strat, flags, pipeline_verify, tel)
                    for i, (arch, tgt, strat, flags) in enumerate(stage_specs)
                ]
                results = _pool_map(
                    _expand_one, payloads, config.workers, config.seed
                )
                for item in results:
                    if isinstance(item, Quarantined):
                        rows.append(None)
                        continue
                    (_, blob, regs, words, occ, stalls, export, obs_export) = item
                    cache.merge(export)
                    _adopt_obs(obs_export)
                    rows.append((container.loads(blob), regs, words, occ, stalls))
        for (arch, tgt, strat, combo), row in zip(stage_specs, rows):
            opts_label = get_strategy(strat).options_label(combo)
            label = f"{arch}/regdem@{tgt}:{opts_label}"
            if row is None:
                quarantine(label)
                continue
            k_out, regs, words, occ, stalls = row
            scored[label] = ScoredVariant(
                label=label,
                arch=arch,
                target=tgt,
                options=opts_label,
                regs=regs,
                demoted_words=words,
                occupancy=occ,
                stalls=stalls,
                stage=stage_name,
            )
            kernels[label] = k_out

    run_stage(specs, "beam")

    own_baseline = f"{own}/nvcc"

    def adjust() -> None:
        """eq. 3 adjustment plus baseline normalization.

        ``adjusted`` applies the occupancy-curve correction (comparable
        within one arch); ``rel`` divides by the same arch's ``nvcc``
        baseline, which is what makes scores comparable *across* archs —
        different architectures' stall/cycle counts are different units.
        """
        occ_max = max(v.occupancy for v in scored.values())
        denom = f_occupancy(occ_max)
        for v in scored.values():
            v.adjusted = f_occupancy(v.occupancy) / denom * v.stalls
        for v in scored.values():
            # every scored arch has a baseline: search archs are a subset of
            # base_archs and anchors are validated on entry
            base = scored[f"{v.arch}/nvcc"]
            v.rel = v.adjusted / base.adjusted if base.adjusted else 1.0

    adjust()
    probes = [v for v in scored.values() if v.stage == "beam"]

    def access_cost(v: ScoredVariant) -> float:
        # exact predictor ties break toward the strategy whose demoted-slot
        # access path is cheaper (registry hints; identical across the
        # paper orderings, so their historical ordering is untouched)
        from repro_torch.arch import get_arch

        from .predictor import strategy_access_cost

        strat = get_strategy(v.options.split(":", 1)[0])
        return strategy_access_cost(strat.hints, get_arch(v.arch))

    beam = sorted(probes, key=lambda v: (v.rel, access_cost(v), v.label))[
        : config.beam_width
    ]
    beam_labels = [v.label for v in beam]

    # -- stage 2: expand the option knobs for beam survivors (each survivor
    #    sweeps its own strategy's remaining combos) ---------------------------
    expand_specs = [
        (v.arch, v.target, strat_name, combo)
        for v in beam
        for strat_name in (v.options.split(":", 1)[0],)
        for combo in get_strategy(strat_name).option_combos(config.full_options)[1:]
    ]
    run_stage(expand_specs, "expand")

    # -- anchors ---------------------------------------------------------------
    for label, k in sorted((extra_variants or {}).items()):
        if label in scored:
            continue
        anchor_arch = arch_of(k).name
        if anchor_arch not in bases:
            # without that arch's nvcc baseline there is nothing comparable
            # to rank the anchor against (cross-arch cycle counts are
            # different units), and the "winner is no worse than any
            # anchor" guarantee would silently break
            raise ValueError(
                f"anchor {label!r} is on arch {anchor_arch!r}, which is not "
                f"part of this search ({sorted(bases)}); include it in "
                "SearchConfig.archs or retarget the anchor"
            )
        occ = achieved_occupancy(k)
        scored[label] = ScoredVariant(
            label=label,
            arch=anchor_arch,
            target=None,
            options=None,
            regs=k.reg_count,
            demoted_words=0,
            occupancy=occ,
            stalls=cache.estimate_stalls(k, occ),
            stage="anchor",
        )
        kernels[label] = k

    adjust()

    # -- stage 3: confirm on the simulator ------------------------------------
    demoted = [v for v in scored.values() if v.stage in ("beam", "expand")]
    top = sorted(demoted, key=lambda v: (v.rel, v.label))[: config.top_k]
    confirm = sorted(
        {v.label for v in scored.values() if v.stage in ("baseline", "anchor")}
        | {v.label for v in top}
    )
    pending_labels: List[str] = []
    cycles: Dict[str, int] = {}
    for label in confirm:
        hit = cache.peek_simulate(kernels[label])
        if hit is not None and not config.profile:
            cycles[label] = hit.total_cycles
        else:
            pending_labels.append(label)
    in_process = config.workers <= 1 or len(pending_labels) <= 1
    with obs.span(
        "search.confirm",
        variants=len(confirm),
        pool=0 if in_process else len(pending_labels),
    ):
        if in_process:
            # batched sweep straight through the parent cache: no
            # serialization round-trips, and variants that share a schedule
            # prefix resume each other's checkpoints (element-wise identical
            # to per-variant simulation — the pooled path below measures the
            # very same results into worker-private caches)
            for label, res in zip(
                pending_labels,
                cache.simulate_batch(
                    [kernels[lb] for lb in pending_labels],
                    profile=config.profile,
                ),
            ):
                cycles[label] = res.total_cycles
        else:
            pending = [
                (i, container.dumps(kernels[lb]), config.profile, tel)
                for i, lb in enumerate(pending_labels)
            ]
            sim_results = _pool_map(
                _simulate_one, pending, config.workers, config.seed
            )
            for lb, item in zip(pending_labels, sim_results):
                if isinstance(item, Quarantined):
                    quarantine(lb)
                    continue
                (_, res, export, obs_export) = item
                cache.merge(export)
                _adopt_obs(obs_export)
                cycles[lb] = res.total_cycles
    if quarantined_labels:
        # a quarantined confirm task left its label without cycles; a
        # variant whose arch baseline itself vanished has nothing
        # comparable to rank against (cross-arch cycle counts are
        # different units) and is dropped with it
        confirm = [
            lb
            for lb in confirm
            if lb in cycles and f"{scored[lb].arch}/nvcc" in cycles
        ]
        if own_baseline not in confirm:
            raise WorkerCrashError(
                f"search cannot rank anything: the input-arch baseline "
                f"{own_baseline!r} was quarantined"
            )
    for label in confirm:
        scored[label].cycles = cycles[label]

    # stall attribution for the confirmed set: served from the merged
    # profiles table (the workers already ran the profiled engine)
    stall_profiles: Dict[str, StallProfile] = {}
    if config.profile:
        for label in confirm:
            stall_profiles[label] = cache.profile(kernels[label])

    # measured cost relative to the same arch's confirmed baseline — the
    # cross-arch-comparable ground truth mirroring ScoredVariant.rel
    def ratio(label: str) -> float:
        return cycles[label] / cycles[f"{scored[label].arch}/nvcc"]

    # exact ties go to the input arch's do-nothing baseline, then by label
    chosen = min(confirm, key=lambda lb: (ratio(lb), lb != own_baseline, lb))
    predictor_choice = min(
        scored.values(), key=lambda v: (v.rel, v.label != own_baseline, v.label)
    ).label
    agreement = ranking_agreement(
        {lb: scored[lb].rel for lb in confirm}, {lb: ratio(lb) for lb in confirm}
    )
    per_arch: Dict[str, str] = {}
    for lb in confirm:
        a = scored[lb].arch
        if a not in per_arch or (ratio(lb), lb) < (ratio(per_arch[a]), per_arch[a]):
            per_arch[a] = lb

    report = SearchReport(
        kernel_name=kernel.name,
        input_arch=own,
        chosen=chosen,
        predictor_choice=predictor_choice,
        baseline=own_baseline,
        space_size=space_size,
        explored=len(specs) + len(expand_specs),
        simulated=len(confirm),
        beam=beam_labels,
        agreement=agreement,
        variants=sorted(scored.values(), key=lambda v: (v.rel, v.label)),
        cycles=cycles,
        speedup=1.0 / ratio(chosen) if ratio(chosen) else 1.0,
        per_arch=per_arch,
        stall_profiles=stall_profiles,
        seconds=time.perf_counter() - t0,
    )
    winner = kernels[chosen]
    if config.verify == "chosen" and scored[chosen].stage in ("beam", "expand"):
        _verify_winner(bases[scored[chosen].arch], winner, chosen)
    # never hand back an alias of the caller's kernel or an anchor
    return SearchOutcome(
        kernel=winner.copy(),
        report=report,
        quarantined=sorted(quarantined_labels),
    )


def _verify_winner(base: Kernel, winner: Kernel, label: str) -> None:
    """The ``verify="chosen"`` deferred self-check: the one kernel a search
    ships gets the full schedule + dataflow-equivalence oracle (baselines
    and anchors are verified where they were built)."""
    from .isa import equivalent
    from .passes import PassVerificationError
    from .sched import verify_schedule

    errs = verify_schedule(winner)
    if errs:
        raise PassVerificationError(
            f"search winner {label!r} has schedule violations: {errs[:3]}"
        )
    if not equivalent(base, winner):
        raise PassVerificationError(
            f"search winner {label!r} is not dataflow-equivalent to its "
            f"arch baseline"
        )

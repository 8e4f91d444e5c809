"""pyReDe — the binary translator driver (paper §1, §5.1).

The paper's tool extracts SASS from a ``.cubin``, applies RegDem, and
re-inserts the code with MaxAs.  The same pipeline runs here on the
pseudo-cubin container of :mod:`repro_torch.binary`:

    disassemble (loads) -> choose targets -> transform (pass pipeline)
        -> self-check -> reassemble (dumps)

``translate`` is bytes-in / bytes-out when handed container bytes — a true
binary->binary translator — and also accepts an in-memory :class:`Kernel`,
returning the full :class:`TranslationReport` for inspection.

Every variant is produced by the unified pass pipeline
(:mod:`repro_torch.core.passes`), which runs the schedule verifier and the
dataflow-equivalence oracle per its ``verify`` policy — the service hot
path uses ``verify="final"`` (both checks once, after the last pass; output
is byte-identical to ``verify="each"``, regression-tested), and
``verify="each"`` remains available to fault-localize a broken pass; the
container round-trip oracle then guards every emitted binary.  A translated
binary that fails any of these is a translator bug, never a tolerated
output.  Per-pass diagnostics/timings surface in
:attr:`TranslationReport.pass_stats`.

``translate`` is the "automatic utility" of §3: it enumerates occupancy
cliffs, generates a RegDem variant per (target x option-combination), and
uses the §4 performance predictor to pick what to ship.

At the service layer, :class:`TranslationService` makes the translator a
**batch, cached, multi-kernel** pipeline: :func:`translate_binary` accepts a
multi-kernel container (format v2), translates every kernel in it, and keys
a :class:`TranslationCache` by per-kernel content CRC
(:func:`repro_torch.binary.container.kernel_crc`) plus the translation parameters,
so a repeated kernel is served byte-identically with zero pipeline passes
run.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.obs import Histogram
from repro_torch.obs import hit_rate as _hit_rate

from .candidates import STRATEGIES
from .isa import Kernel, equivalent, parse_kernel
from .passes import PassStat, PassVerificationError
from .predictor import predict
from .regdem import RegDemOptions, RegDemResult, auto_targets, demote
from .sched import verify_schedule
from .search import SearchConfig, SearchReport, search


class TranslationError(RuntimeError):
    """Raised when a transformed binary fails self-checks."""


class DegradedSearchError(TranslationError):
    """An autotuning search completed only by quarantining crashed tasks.

    The reduced-space winner is verified-correct, but it is **not** the
    fault-free search result, so the strict service layer refuses to cache
    or serve it silently.  The translation daemon catches this and applies
    its degradation policy (retry, then serve the nvcc baseline flagged
    ``degraded``)."""


@dataclass
class TranslationReport:
    kernel_name: str
    baseline_regs: int
    chosen: str
    considered: List[str]
    predictions: Dict[str, float]
    results: Dict[str, RegDemResult] = field(default_factory=dict)
    #: per-pass diagnostics/timings per considered variant label
    pass_stats: Dict[str, List[PassStat]] = field(default_factory=dict)
    #: autotuning search report when this translation came from
    #: :meth:`TranslationService.tune` (``predictions`` then holds each
    #: variant's baseline-relative predicted cost)
    search: Optional[SearchReport] = None

    @property
    def chosen_kernel(self) -> Kernel:
        if self.chosen == "nvcc":
            raise KeyError("baseline chosen; no transformed kernel")
        return self.results[self.chosen].kernel

    @property
    def total_pipeline_seconds(self) -> float:
        """Wall time spent inside transformation passes for this kernel."""
        return sum(p.seconds for stats in self.pass_stats.values() for p in stats)


def option_space(
    strategies: Tuple[str, ...] = STRATEGIES,
    full: bool = False,
) -> List[RegDemOptions]:
    """The optimization-option combinations the predictor searches.

    ``full`` sweeps all 2^4 flag combinations per strategy (the paper's
    exhaustive search); the default uses the grouped Fig.-7 dimensions
    (bank-conflict avoidance, performance-enhancement passes on/off).

    Strategy names resolve through the registry
    (:func:`repro_torch.core.strategies.get_strategy` — unknown names get the
    helpful listing error).  The fixed ``translate`` pipeline builds
    :class:`RegDemOptions`, which only the paper's ordering strategies
    carry; the related-work families are searched via
    :meth:`TranslationService.tune` / :func:`repro_torch.core.search.search`.
    """
    from .strategies import get_strategy

    for strat in strategies:
        s = get_strategy(strat)
        if s.family != "paper":
            raise ValueError(
                f"strategy {strat!r} (family {s.family!r}) has no "
                "RegDemOptions grid; the fixed translate pipeline covers "
                "the paper orderings only — search the related-work "
                "families via TranslationService.tune / repro_torch.core.search"
            )
    out: List[RegDemOptions] = []
    if full:
        for strat in strategies:
            for b, e, r, s in itertools.product([False, True], repeat=4):
                out.append(
                    RegDemOptions(
                        candidate_strategy=strat,
                        bank_avoid=b,
                        elim_redundant=e,
                        reschedule=r,
                        substitute=s,
                    )
                )
    else:
        for strat in strategies:
            for bank in (False, True):
                for enh in (False, True):
                    out.append(
                        RegDemOptions(
                            candidate_strategy=strat,
                            bank_avoid=bank,
                            elim_redundant=enh,
                            reschedule=enh,
                            substitute=enh,
                        )
                    )
    return out


def self_check(original: Kernel, transformed: Kernel, label: str) -> None:
    """Schedule + dataflow validation of one transformed kernel (the same
    checks the pass pipeline applies after every pass)."""
    errs = verify_schedule(transformed)
    if errs:
        raise TranslationError(f"{label}: schedule violations: {errs[:3]}")
    if not equivalent(original, transformed):
        raise TranslationError(f"{label}: dataflow mismatch vs original")


def translate(
    kernel: Union[Kernel, bytes, bytearray, memoryview],
    target_regs: Optional[int] = None,
    options: Optional[List[RegDemOptions]] = None,
    use_predictor: bool = True,
    verify: str = "final",
) -> Union[TranslationReport, bytes]:
    """Run the full pyReDe pipeline on one kernel.

    Given a :class:`Kernel`, returns the :class:`TranslationReport`.  Given
    pseudo-cubin container bytes (:func:`repro_torch.binary.dumps`), runs the same
    pipeline binary->binary — over *every* kernel in the container — and
    returns the container bytes of the chosen variants, the paper's actual
    tool shape.

    ``verify`` is the pass-pipeline self-check policy (default ``"final"``:
    schedule + dataflow checks once per variant pipeline, byte-identical
    output to ``"each"``).
    """
    if isinstance(kernel, (bytes, bytearray, memoryview)):
        out, _ = translate_binary(
            bytes(kernel),
            target_regs=target_regs,
            options=options,
            use_predictor=use_predictor,
            verify=verify,
        )
        return out
    targets = [target_regs] if target_regs is not None else auto_targets(kernel)
    opts = options or option_space()

    variants: Dict[str, Kernel] = {"nvcc": kernel}
    results: Dict[str, RegDemResult] = {}
    ranks: Dict[str, int] = {"nvcc": 0}
    pass_stats: Dict[str, List[PassStat]] = {}
    for tgt in targets:
        for opt in opts:
            label = f"regdem@{tgt}:{opt.label()}"
            # the pipeline self-checks schedule validity and dataflow
            # equivalence per the verify policy; surface failures under the
            # translator's exception type
            try:
                res = demote(kernel, tgt, opt, verify=verify)
            except PassVerificationError as exc:
                raise TranslationError(f"{label}: {exc}") from exc
            variants[label] = res.kernel
            results[label] = res
            pass_stats[label] = res.passes
            ranks[label] = sum(
                (opt.bank_avoid, opt.elim_redundant, opt.reschedule, opt.substitute)
            )

    if use_predictor and len(variants) > 1:
        best, preds = predict(variants, option_rank=ranks)
        predictions = {p.name: p.adjusted for p in preds}
    else:
        best = next(iter(results), "nvcc")
        predictions = {}

    return TranslationReport(
        kernel_name=kernel.name,
        baseline_regs=kernel.reg_count,
        chosen=best,
        considered=sorted(variants),
        predictions=predictions,
        results=results,
        pass_stats=pass_stats,
    )


# ---------------------------------------------------------------------------
# The batch, cached, multi-kernel binary-translation service
# ---------------------------------------------------------------------------


class TranslationCache:
    """Content-CRC-keyed cache of finished translations.

    The key is ``(kernel_crc(kernel), target_regs, option labels,
    use_predictor)`` — everything that determines the translator's output.
    Because a 32-bit CRC can collide, every entry also stores the input
    kernel's rendering and a hit is only served when it matches — a
    colliding kernel is treated as a miss, never given another kernel's
    translation.  A hit returns a *copy* of the chosen kernel (callers may
    mutate it), whose re-serialization is byte-identical to the original
    translation, plus the original :class:`TranslationReport`.  The report
    object is **shared** between the original miss and every later hit:
    treat it as read-only.  No pipeline pass runs on a hit.

    With a persistent ``store`` (:class:`~repro_torch.core.artifacts.
    ArtifactStore`), finished translations **spill to disk** and survive
    process restarts: an in-memory miss falls through to the store, and a
    verified disk entry — chosen-kernel container bytes plus a summary
    report, input-render collision guard intact — is warm-loaded with zero
    pipeline passes run, byte-identical to the original translation, and
    counted in :attr:`disk_hits`.  Warm-loaded reports are **summaries**:
    ``results``/``pass_stats`` are empty (the per-variant kernels were
    never persisted), but ``chosen``/``considered``/``predictions`` and a
    tune's :attr:`TranslationReport.search` (with byte-stable ``to_json``)
    are intact — everything the serving path reads.
    """

    def __init__(self, max_entries: Optional[int] = None, store=None):
        self._entries: Dict[tuple, Tuple[str, Kernel, TranslationReport]] = {}
        self.max_entries = max_entries
        #: optional repro_torch.core.artifacts.ArtifactStore persistence tier
        self.store = store
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        """Hit fraction; raises :class:`ValueError` before any access (a
        rate over zero traffic is undefined, not 0%)."""
        return _hit_rate(self.hits, self.misses)

    def stats(self) -> Dict[str, float]:
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "capacity": self.max_entries,
            "entries": len(self._entries),
            "hit_rate": round(_hit_rate(self.hits, self.misses, default=0.0), 3),
            "disk_hits": self.disk_hits,
        }
        if self.store is not None:
            out["disk_hit_rate"] = self.store.stats()["hit_rate"]
        return out

    @staticmethod
    def content_crc(kernel: Kernel) -> int:
        # kernels decoded from a v2 container carry their verified content
        # CRC; recompute (one text encode) only for v1/in-memory kernels
        crc = getattr(kernel, "content_crc", None)
        if crc is None:
            from repro_torch.binary.container import kernel_crc

            crc = kernel_crc(kernel)
        return crc

    @staticmethod
    def key(
        kernel: Kernel,
        target_regs: Optional[int],
        options: Optional[List[RegDemOptions]],
        use_predictor: bool,
    ) -> tuple:
        opt_sig = None if options is None else tuple(o.label() for o in options)
        return (TranslationCache.content_crc(kernel), target_regs, opt_sig, use_predictor)

    @staticmethod
    def tune_key(kernel: Kernel, config: SearchConfig) -> tuple:
        """Cache key for :meth:`TranslationService.tune` results: content CRC
        plus everything that determines the search outcome.  The pool size is
        not in :meth:`SearchConfig.signature`, so a result tuned with one
        worker is a hit for a later N-worker call (and vice versa)."""
        return (TranslationCache.content_crc(kernel), "tune", config.signature())

    @staticmethod
    def _store_key(key: tuple) -> str:
        """Stable string address of one cache key for the artifact store
        (the tuples hold only ints/strings/bools/None, whose ``repr`` is
        deterministic across processes)."""
        return f"translation:{key!r}"

    @staticmethod
    def _report_to_json(report: TranslationReport) -> dict:
        """The persistable summary of a report (per-variant kernels and
        pass stats are deliberately not spilled — only what serving reads)."""
        return {
            "kernel_name": report.kernel_name,
            "baseline_regs": report.baseline_regs,
            "chosen": report.chosen,
            "considered": list(report.considered),
            "predictions": dict(report.predictions),
            "search": None if report.search is None else report.search.to_json(),
        }

    @staticmethod
    def _report_from_json(data: dict) -> TranslationReport:
        search = None
        if data.get("search") is not None:
            search = SearchReport.from_json(data["search"])
        return TranslationReport(
            kernel_name=data["kernel_name"],
            baseline_regs=data["baseline_regs"],
            chosen=data["chosen"],
            considered=list(data["considered"]),
            predictions=dict(data["predictions"]),
            search=search,
        )

    def _disk_get(
        self, key: tuple, kernel: Kernel
    ) -> Optional[Tuple[Kernel, TranslationReport]]:
        """Warm-load one entry from the persistent store (in-memory miss
        path).  Every byte served was CRC-verified by the store this call;
        the input-render guard and a full container decode re-verify the
        translation-level invariants on top.  A verified load also
        repopulates the in-memory table, so the next hit is memory-speed."""
        entry = self.store.get(self._store_key(key))
        if entry is None:
            return None
        payload, meta = entry
        if meta.get("input_render") != kernel.render():
            return None  # CRC collision or stale schema: recompute
        try:
            from repro_torch.binary import container

            chosen = container.loads(payload)
            report = self._report_from_json(meta["report"])
        except Exception:
            # an entry the store verified but this code version cannot
            # decode (e.g. written by a newer schema) is a miss, not a crash
            return None
        self._entries[key] = (meta["input_render"], chosen.copy(), report)
        self.disk_hits += 1
        if obs.enabled():
            obs.metrics().counter("translation_cache.disk_hits").inc()
        return chosen.copy(), report

    def get(self, key: tuple, kernel: Kernel) -> Optional[Tuple[Kernel, TranslationReport]]:
        entry = self._entries.get(key)
        if entry is not None:
            input_render, chosen, report = entry
            if input_render == kernel.render():
                self.hits += 1
                if obs.enabled():
                    obs.metrics().counter("translation_cache.hits").inc()
                return chosen.copy(), report
        if self.store is not None:
            warm = self._disk_get(key, kernel)
            if warm is not None:
                self.hits += 1
                if obs.enabled():
                    obs.metrics().counter("translation_cache.hits").inc()
                return warm
        self.misses += 1
        if obs.enabled():
            obs.metrics().counter("translation_cache.misses").inc()
        return None

    def put(self, key: tuple, kernel: Kernel, chosen: Kernel, report: TranslationReport) -> None:
        if self.max_entries is not None and len(self._entries) >= self.max_entries:
            # drop the oldest entry (insertion order) — simple FIFO bound
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
            if obs.enabled():
                obs.metrics().counter("translation_cache.evictions").inc()
        self._entries[key] = (kernel.render(), chosen.copy(), report)
        if self.store is not None:
            from repro_torch.binary import container

            self.store.put(
                self._store_key(key),
                container.dumps(chosen),
                meta={
                    "input_render": kernel.render(),
                    "report": self._report_to_json(report),
                },
            )


@dataclass
class BatchTranslationReport:
    """Outcome of one batch translation: per-kernel reports + cache telemetry.

    ``reports`` entries for cached kernels are the *shared* report objects
    from the original translation — read, don't mutate."""

    reports: List[TranslationReport]
    #: per kernel, whether it was served from the translation cache
    cached: List[bool]
    cache_hits: int
    cache_misses: int

    @property
    def kernel_names(self) -> List[str]:
        return [r.kernel_name for r in self.reports]

    @property
    def hit_rate(self) -> float:
        # an empty batch reports 0.0 (display convention, not a decision)
        return _hit_rate(self.cache_hits, self.cache_misses, default=0.0)


class TranslationService:
    """Batch, cached, multi-kernel binary-translation service.

    Holds one :class:`TranslationCache` across calls; feed it multi-kernel
    (or single-kernel) container bytes and it translates every kernel,
    serving repeated content from the cache without running a single
    pipeline pass.
    """

    def __init__(
        self,
        target_regs: Optional[int] = None,
        options: Optional[List[RegDemOptions]] = None,
        use_predictor: bool = True,
        cache: Optional[TranslationCache] = None,
        verify: str = "final",
        store=None,
    ):
        if store is not None and cache is not None:
            raise ValueError(
                "pass either a cache (optionally built with store=...) or a "
                "store, not both"
            )
        self.target_regs = target_regs
        self.options = options
        self.use_predictor = use_predictor
        self.cache = cache if cache is not None else TranslationCache(store=store)
        #: pass-pipeline self-check policy ("final" on the serving hot path;
        #: byte-identical output to "each" — regression-tested)
        self.verify = verify
        # service-level metrics stay always-on (one histogram append per
        # call — nothing per instruction); they are the payload of the
        # planned daemon /metrics endpoint (ROADMAP open item 1)
        self._translate_ms = Histogram()
        self._kernels_done = 0
        self._busy_seconds = 0.0

    def _record_call(self, n_kernels: int, seconds: float) -> None:
        self._translate_ms.observe(seconds * 1e3)
        self._kernels_done += n_kernels
        self._busy_seconds += seconds
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("service.kernels").inc(n_kernels)
            reg.histogram("service.translate_ms").observe(seconds * 1e3)

    @property
    def kernels_per_second(self) -> float:
        """Lifetime service throughput: kernels translated per busy second
        (wall time inside translate/tune calls, idle time excluded)."""
        return self._kernels_done / self._busy_seconds if self._busy_seconds else 0.0

    def metrics_snapshot(self) -> Dict[str, object]:
        """The service's health as one plain dict: call latency distribution
        (p50/p99), throughput, and translation-cache telemetry — the shape
        the future translation daemon will serve from its metrics endpoint."""
        snap = {
            "calls": self._translate_ms.count,
            "kernels": self._kernels_done,
            "kernels_per_s": round(self.kernels_per_second, 3),
            "translate_ms": self._translate_ms.snapshot(),
            "cache": self.cache.stats(),
        }
        if self.cache.store is not None:
            snap["store"] = self.cache.store.stats()
        return snap

    def translate(self, data: bytes) -> Tuple[bytes, BatchTranslationReport]:
        """Container bytes in, container bytes out, every kernel translated."""
        from repro_torch.binary import container
        from repro_torch.binary.roundtrip import RoundTripError, verified_dumps_many

        t_call = time.perf_counter()
        kernels = container.loads_many(data)
        hits0, misses0 = self.cache.hits, self.cache.misses
        chosen_list: List[Kernel] = []
        reports: List[TranslationReport] = []
        cached_flags: List[bool] = []
        with obs.span("service.translate", kernels=len(kernels)):
            for kernel in kernels:
                with obs.span("translate", kernel=kernel.name) as sp:
                    key = self.cache.key(
                        kernel, self.target_regs, self.options, self.use_predictor
                    )
                    entry = self.cache.get(key, kernel)
                    if entry is not None:
                        chosen, report = entry
                        cached_flags.append(True)
                    else:
                        report = translate(
                            kernel,
                            target_regs=self.target_regs,
                            options=self.options,
                            use_predictor=self.use_predictor,
                            verify=self.verify,
                        )
                        chosen = kernel if report.chosen == "nvcc" else report.chosen_kernel
                        self.cache.put(key, kernel, chosen, report)
                        cached_flags.append(False)
                    sp.set(cached=cached_flags[-1], chosen=report.chosen)
                chosen_list.append(chosen)
                reports.append(report)

            try:
                out = verified_dumps_many(chosen_list)
            except RoundTripError as exc:
                raise TranslationError(str(exc)) from exc
        self._record_call(len(kernels), time.perf_counter() - t_call)
        return out, BatchTranslationReport(
            reports=reports,
            cached=cached_flags,
            cache_hits=self.cache.hits - hits0,
            cache_misses=self.cache.misses - misses0,
        )

    def tune(
        self, data: bytes, config: Optional[SearchConfig] = None
    ) -> Tuple[bytes, BatchTranslationReport]:
        """Autotune every kernel in the container (:func:`repro_torch.core.search.
        search`) instead of the fixed predictor-only pipeline.

        Each kernel comes back as its best-found variant; the per-kernel
        :class:`~repro_torch.core.search.SearchReport` rides in the emitted
        container as a ``.note.search.<index>.<name>`` JSON section
        (:func:`repro_torch.binary.container.read_notes`) and on
        :attr:`TranslationReport.search`.  Results are served from the same
        :class:`TranslationCache` as plain translations, keyed by content CRC
        + search signature: re-tuning known content runs **zero** pipeline
        passes and re-emits byte-identical container bytes.
        """
        import json

        from repro_torch.binary import container
        from repro_torch.binary.roundtrip import RoundTripError, verified_dumps_many

        config = config or SearchConfig()
        t_call = time.perf_counter()
        kernels = container.loads_many(data)
        hits0, misses0 = self.cache.hits, self.cache.misses
        chosen_list: List[Kernel] = []
        reports: List[TranslationReport] = []
        cached_flags: List[bool] = []
        notes: Dict[str, bytes] = {}
        with obs.span("service.tune", kernels=len(kernels)):
            for i, kernel in enumerate(kernels):
                with obs.span("tune", kernel=kernel.name) as sp:
                    key = self.cache.tune_key(kernel, config)
                    entry = self.cache.get(key, kernel)
                    if entry is not None:
                        chosen, report = entry
                        cached_flags.append(True)
                    else:
                        outcome = search(kernel, config)
                        if outcome.quarantined:
                            # crashed-and-quarantined tasks shrank the
                            # search space: the result is not the fault-free
                            # one, so never cache or silently serve it
                            raise DegradedSearchError(
                                f"{kernel.name}: search quarantined "
                                f"{len(outcome.quarantined)} crashed task(s) "
                                f"({outcome.quarantined[:3]}); result is not "
                                "the fault-free search outcome"
                            )
                        report = TranslationReport(
                            kernel_name=kernel.name,
                            baseline_regs=kernel.reg_count,
                            chosen=outcome.report.chosen,
                            considered=sorted(v.label for v in outcome.report.variants),
                            predictions={
                                v.label: v.rel for v in outcome.report.variants
                            },
                            search=outcome.report,
                        )
                        chosen = outcome.kernel
                        self.cache.put(key, kernel, chosen, report)
                        cached_flags.append(False)
                    sp.set(cached=cached_flags[-1], chosen=report.chosen)
                chosen_list.append(chosen)
                reports.append(report)
                # SearchReport.to_json is deterministic (no wall times), so a
                # cache-hit re-tune emits byte-identical notes
                notes[f"search.{i}.{kernel.name}"] = json.dumps(
                    report.search.to_json(), sort_keys=True
                ).encode("utf-8")

            try:
                out = verified_dumps_many(chosen_list, notes=notes)
            except RoundTripError as exc:
                raise TranslationError(str(exc)) from exc
        self._record_call(len(kernels), time.perf_counter() - t_call)
        return out, BatchTranslationReport(
            reports=reports,
            cached=cached_flags,
            cache_hits=self.cache.hits - hits0,
            cache_misses=self.cache.misses - misses0,
        )


def translate_binary(
    data: bytes,
    target_regs: Optional[int] = None,
    options: Optional[List[RegDemOptions]] = None,
    use_predictor: bool = True,
    cache: Optional[TranslationCache] = None,
    verify: str = "final",
    tune: bool = False,
    search_config: Optional[SearchConfig] = None,
) -> Tuple[bytes, Union[TranslationReport, BatchTranslationReport]]:
    """Binary->binary pyReDe: container bytes in, container bytes out.

    Disassembles the container, runs the pass pipeline on **every** kernel
    in it (with an optional shared :class:`TranslationCache`), and
    reassembles the chosen variants (the unmodified input kernel where the
    predictor keeps the nvcc baseline).  The emitted container passes the
    round-trip oracle before being returned.

    ``tune=True`` routes through :meth:`TranslationService.tune`: the full
    predictor-guided autotuning search (``search_config``, default
    :class:`~repro_torch.core.search.SearchConfig`) replaces the fixed pipeline,
    and each kernel's search report is embedded as a container note.

    For a single-kernel container the second return value is that kernel's
    :class:`TranslationReport` (the historical contract); for a multi-kernel
    container it is the :class:`BatchTranslationReport`.
    """
    service = TranslationService(
        target_regs=target_regs,
        options=options,
        use_predictor=use_predictor,
        cache=cache,
        verify=verify,
    )
    if tune:
        # the search replaces the fixed pipeline wholesale: silently
        # accepting its knobs would let a caller believe a constraint took
        # effect when it did not
        if target_regs is not None or options is not None or not use_predictor:
            raise ValueError(
                "tune=True replaces the fixed pipeline; target_regs/options/"
                "use_predictor do not apply — configure search_config instead"
            )
        if search_config is None:
            # the default translate verify ("final") maps to the search's
            # own default ("chosen": verify the winner once); an explicit
            # non-default policy is honoured per variant
            search_config = (
                SearchConfig() if verify == "final" else SearchConfig(verify=verify)
            )
        elif verify != "final" and verify != search_config.verify:
            raise ValueError(
                "conflicting verify policies: pass verify through "
                "search_config when tuning"
            )
        out, batch = service.tune(data, search_config)
    else:
        out, batch = service.translate(data)
    if len(batch.reports) == 1:
        return out, batch.reports[0]
    return out, batch


def roundtrip(kernel: Kernel) -> Kernel:
    """Assembler/disassembler round trip (the MaxAs insertion step).

    Pushes the kernel through *both* codecs — the textual SASS rendering and
    the binary container — and demands they agree: an instability in either
    direction is a translator bug.
    """
    text = kernel.render()
    k2 = parse_kernel(
        text,
        threads_per_block=kernel.threads_per_block,
        num_blocks=kernel.num_blocks,
        shared_size=kernel.shared_size,
        demoted_size=kernel.demoted_size,
        live_in=set(kernel.live_in),
        live_out=set(kernel.live_out),
        arch=kernel.arch,
    )
    k2.rda = kernel.rda
    if k2.render().splitlines()[1:] != text.splitlines()[1:]:
        raise TranslationError(f"{kernel.name}: unstable text round trip")
    from repro_torch.binary.roundtrip import RoundTripError, check_roundtrip

    # check_roundtrip's render-identity check is the cross-codec agreement:
    # the decoded kernel re-renders to the exact text parsed above.
    try:
        return check_roundtrip(kernel, check_semantics=False)
    except RoundTripError as exc:
        raise TranslationError(str(exc)) from exc

"""Content-addressed simulation & analysis caching.

The simulator is this repo's measurement instrument, and the benchmark
harness, the predictor calibration, and the translation service all measure
the *same kernels* over and over (fig6's nvcc baselines are fig9's, fig7's
``full`` demotion is table1's ``regdem`` variant, ...).  A
:class:`SimCache` makes every one of those a cache hit:

* **key** — the kernel's content CRC (:func:`repro_torch.binary.container.
  kernel_crc`, the same content address the v2 container stores and the
  translation cache keys) plus the SM configuration and engine parameters;
* **collision guard** — a 32-bit CRC can collide, so every entry stores the
  input kernel's rendering and a hit is only served when it matches: a
  colliding kernel is a miss, never another kernel's measurement;
* **stores** — finished :class:`~repro_torch.core.simulator.SimResult` runs and
  the predictor's whole-program stall estimates (keyed additionally by
  occupancy), both immutable-by-convention; hits return shallow copies.

:data:`DEFAULT_SIM_CACHE` is the process-wide instance shared by
``benchmarks.paper_figs``, :func:`repro_torch.core.predictor.fit_occupancy_curve`,
:func:`repro_torch.core.predictor.predict` (and through it the
:class:`~repro_torch.core.translator.TranslationService` predictor path).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional, Tuple

from repro_torch import obs
from repro_torch.obs import hit_rate as _hit_rate
from repro_torch.obs.stallprof import StallProfile

from .isa import Kernel
from .occupancy import SMConfig
from .simulator import CheckpointStore, SimResult, simulate


def _guard(kernel: Kernel) -> str:
    """Collision-guard string: everything the simulator and the stall
    estimator observe.  ``Kernel.render()`` covers the instruction stream
    and control words; launch geometry and loop trip counts ride alongside
    (they are in the CRC but not in the rendering)."""
    trips = ",".join(
        str(ins.trip_count)
        for ins in kernel.instructions()
        if ins.trip_count is not None
    )
    return (
        f"{kernel.num_blocks}|{kernel.threads_per_block}|"
        f"{kernel.shared_size}|{kernel.demoted_size}|{trips}\n"
        + kernel.render()
    )


class SimCache:
    """Content-addressed cache of simulator runs and stall-estimate analyses.

    ``max_entries`` bounds each table FIFO-style (insertion order), matching
    :class:`repro_torch.core.translator.TranslationCache`; ``None`` is unbounded
    (the benchmark harness working set is small and enumerable).

    ``store`` (an :class:`~repro_torch.core.artifacts.ArtifactStore`) makes the
    ``sims`` and ``stalls`` tables restart-durable: every put spills a
    pickled ``(render, value)`` pair to disk, and a memory miss warm-loads
    from the store before falling through to a real (re-)simulation.
    Profiles and checkpoints stay memory-only — profiles re-derive from one
    profiled run, and checkpoints are bulky mid-trace engine states.
    """

    def __init__(
        self,
        max_entries: Optional[int] = None,
        store: Optional[object] = None,
    ):
        self.max_entries = max_entries
        self.store = store
        self.disk_hits = 0
        #: (crc, sm, max_cycles) -> (render, SimResult)
        self._sims: Dict[tuple, Tuple[str, SimResult]] = {}
        #: (crc, occupancy) -> (render, stalls)
        self._stalls: Dict[tuple, Tuple[str, float]] = {}
        #: (crc, sm, max_cycles) -> (render, StallProfile)
        self._profiles: Dict[tuple, Tuple[str, StallProfile]] = {}
        #: resumable issue-loop states for incremental re-simulation: a miss
        #: on the full-result tables can still resume mid-trace from the
        #: deepest checkpoint whose schedule prefix matches (simulator-owned
        #: keying; exactness is the checkpoint's validity condition)
        self.checkpoints = CheckpointStore()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._sims) + len(self._stalls) + len(self._profiles)

    @property
    def hit_rate(self) -> float:
        """Hit fraction; raises :class:`ValueError` before any access (a
        rate over zero traffic is undefined, not 0%)."""
        return _hit_rate(self.hits, self.misses)

    def stats(self) -> Dict[str, float]:
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "disk_hits": self.disk_hits,
            "evictions": self.evictions,
            "capacity": self.max_entries,
            "hit_rate": round(_hit_rate(self.hits, self.misses, default=0.0), 3),
            "sim_entries": len(self._sims),
            "stall_entries": len(self._stalls),
            "profile_entries": len(self._profiles),
            "checkpoint_entries": len(self.checkpoints),
            "checkpoint_reuse_rate": round(self.checkpoints.reuse_rate, 3),
        }
        if self.store is not None:
            out["disk_hit_rate"] = round(
                _hit_rate(self.disk_hits, self.misses, default=0.0), 3
            )
        return out

    def clear(self) -> None:
        self._sims.clear()
        self._stalls.clear()
        self._profiles.clear()
        self.checkpoints.clear()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.evictions = 0

    # -- keying ---------------------------------------------------------------

    @staticmethod
    def content_key(kernel: Kernel) -> int:
        """The kernel's content address (v2-container CRC, recomputed only
        for kernels that did not come out of a v2 container)."""
        crc = getattr(kernel, "content_crc", None)
        if crc is None:
            from repro_torch.binary.container import kernel_crc

            crc = kernel_crc(kernel)
        return crc

    #: tables that spill to / warm-load from the artifact store
    _DURABLE_TABLES = ("sims", "stalls")

    @staticmethod
    def _store_key(table_name: str, key: tuple) -> str:
        return f"simcache:{table_name}:{key!r}"

    def _disk_get(self, table_name: str, key: tuple, render: str):
        """Warm-load one entry from the artifact store, or ``None``.

        The store already CRC-verifies the payload; the unpickle guard and
        the render comparison protect against a key collision or a payload
        written by an incompatible version — either is a miss, never a
        wrong value."""
        entry = self.store.get(self._store_key(table_name, key))
        if entry is None:
            return None
        payload, _meta = entry
        try:
            stored_render, value = pickle.loads(payload)
        except Exception:
            return None
        if stored_render != render:
            return None
        return value

    def _get(self, table: dict, key: tuple, render: str, table_name: str = ""):
        entry = table.get(key)
        if entry is not None and entry[0] == render:
            self.hits += 1
            if obs.enabled():
                obs.metrics().counter("simcache.hits").inc()
            return entry[1]
        if self.store is not None and table_name in self._DURABLE_TABLES:
            value = self._disk_get(table_name, key, render)
            if value is not None:
                # repopulate memory without re-spilling what disk just served
                self._mem_put(table, key, render, value)
                self.hits += 1
                self.disk_hits += 1
                if obs.enabled():
                    obs.metrics().counter("simcache.hits").inc()
                    obs.metrics().counter("simcache.disk_hits").inc()
                return value
        self.misses += 1
        if obs.enabled():
            obs.metrics().counter("simcache.misses").inc()
        return None

    def _mem_put(self, table: dict, key: tuple, render: str, value) -> None:
        if self.max_entries is not None and len(table) >= self.max_entries:
            table.pop(next(iter(table)))
            self.evictions += 1
            if obs.enabled():
                obs.metrics().counter("simcache.evictions").inc()
        table[key] = (render, value)

    def _put(
        self, table: dict, key: tuple, render: str, value, table_name: str = ""
    ) -> None:
        self._mem_put(table, key, render, value)
        if self.store is not None and table_name in self._DURABLE_TABLES:
            try:
                payload = pickle.dumps((render, value), protocol=4)
            except Exception:
                return  # unpicklable value: memory-only, never fatal
            self.store.put(
                self._store_key(table_name, key),
                payload,
                meta={"table": table_name},
            )

    # -- cached operations ----------------------------------------------------

    def simulate(
        self,
        kernel: Kernel,
        sm: Optional[SMConfig] = None,
        max_cycles: int = 50_000_000,
    ) -> SimResult:
        """:func:`repro_torch.core.simulator.simulate`, content-cached.

        ``sm=None`` resolves to the kernel's architecture SM configuration
        *before* keying, so the same kernel simulated with and without an
        explicit (identical) SMConfig shares one cache entry.

        A full-result miss still goes through :attr:`checkpoints`: the run
        resumes from the deepest valid mid-trace state a sibling kernel
        captured and contributes its own captures back (incremental
        re-simulation)."""
        if sm is None:
            from repro_torch.arch import arch_of

            sm = arch_of(kernel).sm
        key = (self.content_key(kernel), sm, max_cycles)
        render = _guard(kernel)
        hit = self._get(self._sims, key, render, "sims")
        if hit is not None:
            return dataclasses.replace(hit)
        res = simulate(kernel, sm, max_cycles, checkpoints=self.checkpoints)
        self._put(self._sims, key, render, res, "sims")
        return dataclasses.replace(res)

    def peek_simulate(
        self,
        kernel: Kernel,
        sm: Optional[SMConfig] = None,
        max_cycles: int = 50_000_000,
    ) -> Optional[SimResult]:
        """Return the cached :class:`SimResult` for ``kernel`` if present,
        else ``None`` — without running the simulator and without touching
        the hit/miss counters (used by the search engine to partition work
        before fanning the remainder out to a process pool)."""
        if sm is None:
            from repro_torch.arch import arch_of

            sm = arch_of(kernel).sm
        key = (self.content_key(kernel), sm, max_cycles)
        entry = self._sims.get(key)
        if entry is not None and entry[0] == _guard(kernel):
            return dataclasses.replace(entry[1])
        return None

    def profile(
        self,
        kernel: Kernel,
        sm: Optional[SMConfig] = None,
        max_cycles: int = 50_000_000,
    ) -> StallProfile:
        """Stall-attribution profile of ``kernel``, content-cached.

        A miss runs the profiled engine once and warms *both* tables: the
        :class:`~repro_torch.obs.stallprof.StallProfile` here and the (identical
        cycle counts, see ``simulate(profile=True)``) :class:`SimResult` in
        the plain simulation table, so a profiled confirm stage leaves the
        cache as warm as an unprofiled one."""
        if sm is None:
            from repro_torch.arch import arch_of

            sm = arch_of(kernel).sm
        key = (self.content_key(kernel), sm, max_cycles)
        render = _guard(kernel)
        hit = self._get(self._profiles, key, render, "profiles")
        if hit is not None:
            return hit
        res = simulate(
            kernel, sm, max_cycles, profile=True, checkpoints=self.checkpoints
        )
        prof = res.stall_profile
        self._put(self._profiles, key, render, prof, "profiles")
        if key not in self._sims:
            self._put(
                self._sims,
                key,
                render,
                dataclasses.replace(res, stall_profile=None),
                "sims",
            )
        return prof

    def simulate_batch(
        self,
        kernels,
        sm: Optional[SMConfig] = None,
        max_cycles: int = 50_000_000,
        profile: bool = False,
    ):
        """Batched :meth:`simulate`/:meth:`profile` over sibling kernels.

        Delegates to :func:`repro_torch.core.simulator.simulate_batch` with this
        cache plugged in: content-identical members dedup through the
        result tables, and distinct members that share a schedule prefix
        resume each other's checkpoints.  Element-wise identical to calling
        :meth:`simulate` per kernel."""
        from .simulator import simulate_batch as _simulate_batch

        return _simulate_batch(
            kernels, sm, max_cycles, profile=profile, cache=self
        )

    def estimate_stalls(self, kernel: Kernel, occupancy: float) -> float:
        """:func:`repro_torch.core.predictor.estimate_stalls`, content-cached.

        Occupancy is part of the key: the estimate scales per-instruction
        stalls by it (eq. 2), so the same binary at a different occupancy is
        a different analysis.
        """
        key = (self.content_key(kernel), occupancy)
        render = _guard(kernel)
        hit = self._get(self._stalls, key, render, "stalls")
        if hit is not None:
            return hit
        from .predictor import estimate_stalls

        val = estimate_stalls(kernel, occupancy)
        self._put(self._stalls, key, render, val, "stalls")
        return val

    # -- pool-worker cache exchange -------------------------------------------

    def export(self) -> Dict[str, dict]:
        """Snapshot every entry as a picklable payload for :meth:`merge`.

        A search-pool worker runs with a fresh private cache, does its
        measurements, and ships the entries back to the parent so the
        process-wide cache ends a parallel search exactly as warm as a
        serial one would leave it.  Checkpoints stay local: they are
        mid-trace engine states, bulky and machine-local by nature, and
        re-deriving them is one partial simulation."""
        return {
            "sims": dict(self._sims),
            "stalls": dict(self._stalls),
            "profiles": dict(self._profiles),
        }

    def merge(self, exported: Dict[str, dict]) -> int:
        """Adopt entries from an :meth:`export` payload; first writer wins
        (an existing entry is never overwritten, so the merge result does
        not depend on worker completion order).  Returns the number of
        entries added."""
        added = 0
        for name, table, incoming in (
            ("sims", self._sims, exported.get("sims", {})),
            ("stalls", self._stalls, exported.get("stalls", {})),
            ("profiles", self._profiles, exported.get("profiles", {})),
        ):
            for key in sorted(incoming, key=repr):
                if key not in table:
                    render, value = incoming[key]
                    self._put(table, key, render, value, name)
                    added += 1
        return added


#: Process-wide cache shared by the benchmark harness, the predictor, and
#: the translation service's predictor path.  Bounded: the harness working
#: set is tiny, but the service path feeds this cache one stall-estimate
#: entry per (kernel, occupancy) it predicts over, and a long-running
#: service must not grow memory without bound.
DEFAULT_SIM_CACHE = SimCache(max_entries=4096)


def simulate_cached(
    kernel: Kernel,
    sm: Optional[SMConfig] = None,
    max_cycles: int = 50_000_000,
    cache: Optional[SimCache] = None,
) -> SimResult:
    """Content-cached :func:`~repro_torch.core.simulator.simulate` (process-wide
    :data:`DEFAULT_SIM_CACHE` unless a cache is supplied)."""
    if cache is None:
        cache = DEFAULT_SIM_CACHE
    return cache.simulate(kernel, sm, max_cycles)


def estimate_stalls_cached(
    kernel: Kernel,
    occupancy: float,
    cache: Optional[SimCache] = None,
) -> float:
    """Content-cached :func:`~repro_torch.core.predictor.estimate_stalls`."""
    if cache is None:
        cache = DEFAULT_SIM_CACHE
    return cache.estimate_stalls(kernel, occupancy)

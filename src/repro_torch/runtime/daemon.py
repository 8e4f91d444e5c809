"""Fault-tolerant translation daemon (ROADMAP "translation daemon" item).

:class:`TranslationDaemon` turns the batch
:class:`~repro_torch.core.translator.TranslationService` into a long-running
server with the failure semantics a serving tier needs:

* **async request queue + continuous batching** — ``submit()`` enqueues and
  returns a handle immediately; a bounded worker pool (``max_batch`` slots)
  drains the queue, refilling each slot the moment a request finishes, so
  the daemon never waits for a full batch to form;
* **per-request deadlines** — a watchdog thread scans in-flight requests
  and completes any that blow their deadline *at* the deadline, whether the
  translation is still queued, mid-search, or hung;
* **bounded retry with backoff** — transient failures (an injected fault, a
  quarantine-narrowed search, a crashed worker pool) are retried up to
  ``max_retries`` times with exponential backoff before the daemon gives
  up on the fast path;
* **graceful degradation, never corruption** — when retries are exhausted
  or the deadline fires, the response is the input's **nvcc-baseline
  container bytes** (the do-nothing translation: parse, re-emit, round-trip
  verified) flagged ``degraded``, with the reason attached.  Every response
  is therefore byte-identical to the fault-free translation *or* an
  explicitly-flagged baseline — never silently wrong bytes, never a hang
  past the deadline.  Input that cannot even be parsed
  (:class:`~repro_torch.binary.container.ContainerError`) is a clean ``error``
  response: there is no baseline for garbage.

Completion is **idempotent**: the first completer (worker or watchdog)
wins, a late worker result is counted (``late_results``) and dropped.

Restart durability comes from the layer below: hand the daemon (or its
service) an :class:`~repro_torch.core.artifacts.ArtifactStore` and every tuned
kernel it serves is spilled to disk — a restarted daemon answers repeat
content from the store with zero pipeline passes (``disk_hits`` in
:meth:`metrics_snapshot`).
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch import obs
from repro_torch.core.search import SearchConfig
from repro_torch.core.translator import BatchTranslationReport, TranslationService
from repro_torch.obs import Histogram
from repro_torch.testing import faults as _faults

#: response statuses
OK = "ok"
DEGRADED = "degraded"
ERROR = "error"


@dataclass(frozen=True)
class DaemonConfig:
    """Knobs of the serving loop."""

    #: concurrent translation slots (continuous batching width)
    max_batch: int = 4
    #: wall-clock budget per request, submit to response
    deadline_s: float = 30.0
    #: transient-failure retries before degrading (attempts = retries + 1)
    max_retries: int = 2
    #: first retry delay; doubles per retry
    backoff_s: float = 0.05
    #: watchdog scan interval (deadline enforcement granularity)
    watchdog_s: float = 0.005


@dataclass
class DaemonRequest:
    """One unit of work: container bytes plus how to translate them."""

    request_id: int
    data: bytes
    #: "translate" (fixed predictor pipeline) or "tune" (autotuning search)
    mode: str = "translate"
    #: search knobs for ``mode="tune"``
    config: Optional[SearchConfig] = None
    #: per-request deadline override (None = DaemonConfig.deadline_s)
    deadline_s: Optional[float] = None


@dataclass
class DaemonResponse:
    """What a request resolves to — exactly one of three shapes.

    ``status == "ok"``: ``payload`` is the fault-free translation.
    ``status == "degraded"``: ``payload`` is the input's round-trip-verified
    nvcc-baseline bytes and ``reason`` says why the fast path was abandoned.
    ``status == "error"``: ``payload`` is ``None`` (unusable input).
    """

    request_id: int
    status: str
    payload: Optional[bytes] = None
    report: Optional[BatchTranslationReport] = None
    reason: str = ""
    #: translation attempts consumed (0 = never started)
    attempts: int = 0
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK

    @property
    def degraded(self) -> bool:
        return self.status == DEGRADED


class PendingResponse:
    """Caller-side handle: ``result()`` blocks until the daemon responds."""

    def __init__(self, request: DaemonRequest, deadline: float, submitted: float):
        self.request = request
        self.deadline = deadline
        self.submitted = submitted
        self.attempts = 0
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._response: Optional[DaemonResponse] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, response: DaemonResponse) -> bool:
        """First completer wins; returns whether *this* call won."""
        with self._lock:
            if self._response is not None:
                return False
            self._response = response
        self._event.set()
        return True

    def result(self, timeout: Optional[float] = None) -> DaemonResponse:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} still pending"
            )
        return self._response


class TranslationDaemon:
    """Supervised serving loop around one :class:`TranslationService`.

    Usable as a context manager; otherwise call :meth:`start` / :meth:`stop`.
    ``service`` defaults to a fresh ``TranslationService(store=store)`` —
    pass ``store`` to make the daemon restart-durable.
    """

    def __init__(
        self,
        service: Optional[TranslationService] = None,
        config: Optional[DaemonConfig] = None,
        store=None,
    ):
        if service is not None and store is not None:
            raise ValueError("pass either a service or a store, not both")
        self.service = service or TranslationService(store=store)
        self.config = config or DaemonConfig()
        self._ids = itertools.count(1)
        self._inflight: Dict[int, PendingResponse] = {}
        self._inflight_lock = threading.Lock()
        self._serve_ms = Histogram()
        self.counters = {
            "requests": 0,
            "ok": 0,
            "degraded": 0,
            "errors": 0,
            "retries": 0,
            "deadline_timeouts": 0,
            "late_results": 0,
        }
        self._counter_lock = threading.Lock()
        self._running = False
        self._pool: Optional[ThreadPoolExecutor] = None
        self._watchdog: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "TranslationDaemon":
        if self._running:
            return self
        self._running = True
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.max_batch,
            thread_name_prefix="regdem-daemon",
        )
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="regdem-watchdog", daemon=True
        )
        self._watchdog.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut the daemon down.

        ``drain=True`` lets queued/in-flight work finish (the watchdog keeps
        enforcing deadlines throughout, so the wait is bounded by the
        longest outstanding deadline); ``drain=False`` cancels queued work
        and degrades whatever is still pending."""
        if not self._running:
            return
        if self._pool is not None:
            self._pool.shutdown(wait=drain, cancel_futures=not drain)
        self._running = False
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None
        if not drain:
            for pending in self._snapshot_inflight():
                self._finish_degraded(pending, "daemon shutdown")
        self._pool = None

    def __enter__(self) -> "TranslationDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        data: bytes,
        mode: str = "translate",
        config: Optional[SearchConfig] = None,
        deadline_s: Optional[float] = None,
    ) -> PendingResponse:
        """Enqueue one request; returns immediately with a handle."""
        if not self._running:
            raise RuntimeError("daemon is not running (use start() or `with`)")
        if mode not in ("translate", "tune"):
            raise ValueError(f"unknown mode {mode!r}")
        req = DaemonRequest(
            request_id=next(self._ids),
            data=data,
            mode=mode,
            config=config,
            deadline_s=deadline_s,
        )
        now = time.monotonic()
        budget = deadline_s if deadline_s is not None else self.config.deadline_s
        pending = PendingResponse(req, deadline=now + budget, submitted=now)
        with self._inflight_lock:
            self._inflight[req.request_id] = pending
        self._count("requests")
        if obs.enabled():
            obs.metrics().counter("daemon.requests").inc()
        self._pool.submit(self._serve, pending)
        return pending

    def request(
        self,
        data: bytes,
        mode: str = "translate",
        config: Optional[SearchConfig] = None,
        deadline_s: Optional[float] = None,
    ) -> DaemonResponse:
        """Blocking convenience wrapper: submit and wait for the response
        (the deadline bounds the wait, so this always returns)."""
        return self.submit(data, mode, config, deadline_s).result()

    # -- the serving path -----------------------------------------------------

    def _serve(self, pending: PendingResponse) -> None:
        from repro_torch.binary.container import ContainerError

        req = pending.request
        backoff = self.config.backoff_s
        last_exc: Optional[BaseException] = None
        for attempt in range(self.config.max_retries + 1):
            if pending.done:  # deadline fired while queued or mid-retry
                return
            pending.attempts = attempt + 1
            try:
                self._inject(req, attempt, pending)
                if pending.done:
                    return
                if req.mode == "tune":
                    payload, report = self.service.tune(req.data, req.config)
                else:
                    payload, report = self.service.translate(req.data)
            except ContainerError as exc:
                # the *input* is unusable: retrying cannot help and there is
                # no baseline to degrade to
                self._finish(
                    pending,
                    DaemonResponse(
                        request_id=req.request_id,
                        status=ERROR,
                        reason=f"invalid input container: {exc}",
                        attempts=pending.attempts,
                    ),
                )
                return
            except Exception as exc:
                last_exc = exc
                self._count("retries")
                if obs.enabled():
                    obs.metrics().counter("daemon.retries").inc()
                if attempt < self.config.max_retries:
                    # waits on the completion event: a deadline completion
                    # aborts the backoff instead of sleeping through it
                    pending._event.wait(backoff)
                    backoff *= 2.0
                continue
            self._finish(
                pending,
                DaemonResponse(
                    request_id=req.request_id,
                    status=OK,
                    payload=payload,
                    report=report,
                    attempts=pending.attempts,
                ),
            )
            return
        self._finish_degraded(
            pending,
            f"translation failed after {pending.attempts} attempt(s): "
            f"{last_exc!r}",
        )

    def _inject(self, req: DaemonRequest, attempt: int, pending: PendingResponse) -> None:
        """Deterministic chaos hooks (no-ops without an installed plan)."""
        inj = _faults.active()
        if inj is None:
            return
        key = str(req.request_id)
        if inj.fire("daemon.latency", key, attempt):
            # a stuck translation: park until the plan's latency elapses or
            # the watchdog completes the request out from under us
            pending._event.wait(inj.plan.latency_s)
        if inj.fire("daemon.error", key, attempt):
            raise _faults.FaultError(
                f"injected daemon.error for request {key} attempt {attempt}"
            )

    def _baseline_bytes(self, data: bytes) -> bytes:
        """The do-nothing translation: parse, re-emit, round-trip verified.

        This is what "degraded" serves — valid container bytes for the
        *input* kernels, zero RegDem passes, never corrupt (the round-trip
        oracle still guards the emission)."""
        from repro_torch.binary import container
        from repro_torch.binary.roundtrip import verified_dumps_many

        return verified_dumps_many(container.loads_many(data))

    def _finish_degraded(self, pending: PendingResponse, reason: str) -> None:
        req = pending.request
        try:
            payload = self._baseline_bytes(req.data)
            status = DEGRADED
        except Exception as exc:  # unusable input: clean error, no bytes
            payload = None
            status = ERROR
            reason = f"{reason}; baseline emission failed: {exc}"
        self._finish(
            pending,
            DaemonResponse(
                request_id=req.request_id,
                status=status,
                payload=payload,
                reason=reason,
                attempts=pending.attempts,
            ),
        )

    def _finish(self, pending: PendingResponse, response: DaemonResponse) -> None:
        response.latency_s = time.monotonic() - pending.submitted
        if not pending._complete(response):
            self._count("late_results")
            if obs.enabled():
                obs.metrics().counter("daemon.late_results").inc()
            return
        with self._inflight_lock:
            self._inflight.pop(pending.request.request_id, None)
        self._serve_ms.observe(response.latency_s * 1e3)
        key = {OK: "ok", DEGRADED: "degraded", ERROR: "errors"}[response.status]
        self._count(key)
        if obs.enabled():
            obs.metrics().counter(f"daemon.{key}").inc()
            obs.metrics().histogram("daemon.serve_ms").observe(
                response.latency_s * 1e3
            )

    # -- deadline watchdog ----------------------------------------------------

    def _snapshot_inflight(self):
        with self._inflight_lock:
            return list(self._inflight.values())

    def _watchdog_loop(self) -> None:
        while self._running:
            now = time.monotonic()
            for pending in self._snapshot_inflight():
                if not pending.done and now >= pending.deadline:
                    self._count("deadline_timeouts")
                    if obs.enabled():
                        obs.metrics().counter("daemon.deadline_timeouts").inc()
                    self._finish_degraded(
                        pending,
                        f"deadline exceeded "
                        f"({now - pending.submitted:.3f}s elapsed)",
                    )
            time.sleep(self.config.watchdog_s)

    # -- introspection --------------------------------------------------------

    def _count(self, key: str) -> None:
        with self._counter_lock:
            self.counters[key] += 1

    def metrics_snapshot(self) -> Dict[str, object]:
        """Daemon health + the wrapped service's snapshot (which carries the
        translation cache's ``disk_hits``/``disk_hit_rate`` and the artifact
        store's stats when a store is attached)."""
        with self._counter_lock:
            counters = dict(self.counters)
        completed = counters["ok"] + counters["degraded"] + counters["errors"]
        snap: Dict[str, object] = {
            "running": self._running,
            "inflight": len(self._inflight),
            "serve_ms": self._serve_ms.snapshot(),
            "completed": completed,
            "degradation_rate": round(
                counters["degraded"] / completed if completed else 0.0, 3
            ),
            "service": self.service.metrics_snapshot(),
        }
        snap.update(counters)
        return snap

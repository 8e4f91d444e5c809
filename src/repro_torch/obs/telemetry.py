"""Hierarchical spans with near-zero overhead when disabled.

One process-wide :class:`Telemetry` instance records *spans* — named,
attributed, parent-linked wall-time intervals — across every subsystem
(the serving loop, pass pipelines, translations, search stages, simulator
runs).  The port's own copy of the reference package's
telemetry.  The design constraints, in order:

1. **Disabled is free.**  ``span()`` with telemetry off performs one
   attribute check and returns a shared no-op singleton: no allocation, no
   clock read, no event.  Hot paths can therefore be instrumented at call
   granularity without a disabled-mode tax.
2. **Exception-safe nesting.**  Spans are context managers; an exception
   closes (and records) every open span on the way out, so a crashed
   pipeline still leaves a coherent timeline.
3. **Pool-mergeable.**  Timestamps come from ``time.perf_counter()``
   (CLOCK_MONOTONIC — one clock machine-wide), and every record carries its
   ``pid``, so spans captured in pool workers merge into the parent
   timeline (:meth:`Telemetry.export_events` / :meth:`Telemetry.adopt`).
4. **On the device trace's clock.**  While a torch profiler records, each
   enabled span also opens a profiler range of its name, so the profiler's
   timeline holds the span beside the kernels its code launched, with no
   second clock (:func:`_profiler_range`).  Importing this package loads no
   torch: the range is looked up through ``sys.modules``, where only a
   program that imported torch can have started a profiler.

Exporters live in :mod:`repro_torch.obs.export` (JSONL event log, Chrome
trace-format for ``chrome://tracing`` / Perfetto).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .metrics import MetricsRegistry


@dataclass
class SpanRecord:
    """One closed span: a named wall-time interval with attributes."""

    name: str
    #: perf_counter seconds at span open (monotonic, comparable across
    #: processes on one machine)
    ts: float
    #: wall-time duration in seconds (>= 0)
    dur: float
    span_id: int
    #: enclosing span's id, or None for a root span
    parent_id: Optional[int]
    pid: int
    tid: int
    attrs: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "ts": self.ts,
            "dur": self.dur,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "pid": self.pid,
            "tid": self.tid,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The disabled-mode span: a shared, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    """An open profiler range named ``name`` while a torch profiler records,
    else None.  The range has the profiler's function scope: it is a host
    op on the trace, as an ``aten::`` op is, and the profiler makes no
    device-side copy of it (a ``record_function`` range gets one, which
    spans its kernels on the device's rows and reads as device work).
    Torch is never imported here: a process that has not loaded it runs no
    profiler."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class Span:
    """One live span; records itself on ``__exit__`` (exceptions included)."""

    __slots__ = ("_tel", "name", "attrs", "_t0", "span_id", "parent_id", "_range")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, object]):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        """Attach attributes to the live span (e.g. an outcome computed
        mid-flight)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tel = self._tel
        self.span_id = tel._next_id()
        stack = tel._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self._range = _profiler_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tel = self._tel
        stack = tel._stack()
        # pop back to this span even if an inner span leaked (belt and
        # braces: context-managed spans cannot leak, but a coherent
        # timeline beats an assertion here)
        while stack and stack[-1] != self.span_id:
            stack.pop()
        if stack:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tel.events.append(
            SpanRecord(
                name=self.name,
                ts=self._t0,
                dur=t1 - self._t0,
                span_id=self.span_id,
                parent_id=self.parent_id,
                pid=os.getpid(),
                tid=threading.get_ident(),
                attrs=self.attrs,
            )
        )
        return False


class Telemetry:
    """The process-wide telemetry state: an on/off switch, the recorded
    span list, and the shared :class:`~repro_torch.obs.metrics.MetricsRegistry`."""

    def __init__(self) -> None:
        self.enabled = False
        self.events: List[SpanRecord] = []
        self.registry = MetricsRegistry()
        self._local = threading.local()
        self._id = 0
        self._id_lock = threading.Lock()

    # -- span machinery --------------------------------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._id_lock:
            self._id += 1
            # pid-prefixed so worker-recorded ids never collide with the
            # parent's after a merge (fork copies the counter)
            return (os.getpid() << 20) | (self._id & 0xFFFFF)

    def span(self, name: str, **attrs) -> object:
        """A context-managed span, or the free no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    # -- switch / lifecycle -----------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded span and metric (the switch is untouched)."""
        self.events.clear()
        self.registry.clear()
        self._local = threading.local()

    # -- pool-worker exchange -----------------------------------------------------

    def event_count(self) -> int:
        return len(self.events)

    def export_events(self, since: int = 0) -> List[SpanRecord]:
        """Spans recorded at index ``since`` onward, as a picklable list
        (a forked pool worker inherits the parent's prefix — export only
        what the task itself added)."""
        return list(self.events[since:])

    def adopt(self, records: List[SpanRecord]) -> int:
        """Merge worker-exported spans into this timeline; returns the
        number adopted.  Records keep their own pid/ids, so the Chrome
        trace renders each worker as its own process row."""
        self.events.extend(records)
        return len(records)

    def snapshot(self) -> Dict[str, object]:
        """Telemetry self-description plus the full metrics snapshot."""
        return {
            "enabled": self.enabled,
            "spans": len(self.events),
            "metrics": self.registry.snapshot(),
        }


#: The process-wide instance every subsystem instruments against.
DEFAULT_TELEMETRY = Telemetry()


def get_telemetry() -> Telemetry:
    return DEFAULT_TELEMETRY


def span(name: str, **attrs) -> object:
    """Module-level shorthand for ``DEFAULT_TELEMETRY.span``."""
    tel = DEFAULT_TELEMETRY
    if not tel.enabled:
        return NULL_SPAN
    return Span(tel, name, attrs)


def enabled() -> bool:
    return DEFAULT_TELEMETRY.enabled


def enable() -> None:
    DEFAULT_TELEMETRY.enable()


def disable() -> None:
    DEFAULT_TELEMETRY.disable()


def reset() -> None:
    DEFAULT_TELEMETRY.reset()


def metrics() -> MetricsRegistry:
    return DEFAULT_TELEMETRY.registry

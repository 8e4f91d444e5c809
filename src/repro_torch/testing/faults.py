"""Deterministic, seed-driven fault injection.

The chaos suite's one source of misfortune.  A :class:`FaultPlan` describes
*which* faults to inject — torn artifact writes, bit-flipped payloads,
pool-worker crashes, injected latency, transient translate errors — and a
:class:`FaultInjector` wraps a plan with counters.  Decisions are **pure
functions of (seed, site, key, attempt)**: no hidden RNG state, so the same
plan injects the same faults on every run, in every process (pool workers
included), and a retried attempt rolls a *different* die than the attempt
it is retrying — which is what lets a test script "fail twice, then
succeed".

Sites (the strings production code passes to :meth:`FaultInjector.fire`):

==================  ========================================================
``store.torn``      artifact-store write is torn: the entry file is left
                    truncated on disk, as if the process died mid-write
``store.tmp``       artifact-store write dies *before* the atomic rename:
                    a stale ``*.tmp`` is left behind, the entry never lands
``store.flip``      one bit of a stored payload is flipped on read (media
                    corruption; the store's CRC must catch it)
``worker.crash``    a pool worker hard-exits (``os._exit``) while running
                    the task — only ever consulted inside worker processes
``daemon.error``    a transient translation failure (raises FaultError)
``daemon.latency``  extra seconds of latency injected before translating
==================  ========================================================

Production modules consult the **process-global** injector via
:func:`active` (``None`` when no plan is installed — the only cost in
production is one module-attribute read).  Tests install one with
:func:`install` or the :func:`injected` context manager; the supervised
worker pool forwards the parent's plan to its children so crash schedules
hold across process boundaries.
"""

from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, Optional


class FaultError(RuntimeError):
    """An injected (transient) failure — never raised by real code paths."""


def _roll(seed: int, site: str, key: str, attempt: int) -> float:
    """Deterministic uniform draw in [0, 1) for one (site, key, attempt).

    CRC32 of the identifying string: stable across processes, platforms and
    Python versions (unlike ``hash``), cheap, and good enough to spread
    probabilities — this is a test harness, not a cryptographic sampler.
    """
    h = zlib.crc32(f"{seed}|{site}|{key}|{attempt}".encode("utf-8"))
    return (h & 0xFFFFFFFF) / 4294967296.0


@dataclass(frozen=True)
class FaultPlan:
    """What to inject.  Probabilities are per-(site, key, attempt) and
    decided deterministically; ``schedule`` overrides them with explicit
    "inject the first N attempts of this (site, key)" entries — the tool
    for scripting "this task kills its worker exactly twice"."""

    seed: int = 0
    #: probability a store write is torn (truncated final file)
    torn_write_p: float = 0.0
    #: probability a store write dies before its rename (stale tmp file)
    tmp_write_p: float = 0.0
    #: probability a stored payload suffers a bit flip on read
    bit_flip_p: float = 0.0
    #: probability a pool worker crashes while running a task
    worker_crash_p: float = 0.0
    #: probability one translate attempt raises a transient FaultError
    error_p: float = 0.0
    #: probability of injecting ``latency_s`` before a translate attempt
    latency_p: float = 0.0
    #: seconds of latency injected when the latency die fires
    latency_s: float = 0.0
    #: explicit schedules: ``{(site, key): n}`` injects the fault for
    #: attempts 0..n-1 of that (site, key), regardless of probabilities
    schedule: Dict[tuple, int] = field(default_factory=dict)

    _SITE_P = {
        "store.torn": "torn_write_p",
        "store.tmp": "tmp_write_p",
        "store.flip": "bit_flip_p",
        "worker.crash": "worker_crash_p",
        "daemon.error": "error_p",
        "daemon.latency": "latency_p",
    }

    def decide(self, site: str, key: str = "", attempt: int = 0) -> bool:
        """Should this fault fire?  Pure — same answer every time."""
        n = self.schedule.get((site, key))
        if n is not None:
            return attempt < n
        p = getattr(self, self._SITE_P[site], 0.0)
        if p <= 0.0:
            return False
        if p >= 1.0:
            return True
        return _roll(self.seed, site, key, attempt) < p


class FaultInjector:
    """A :class:`FaultPlan` plus injection counters (what actually fired)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected: Dict[str, int] = {}

    def fire(self, site: str, key: str = "", attempt: int = 0) -> bool:
        """Decide and, when firing, count.  Decision is deterministic; the
        counters are this process's observation of it."""
        if self.plan.decide(site, key, attempt):
            self.injected[site] = self.injected.get(site, 0) + 1
            return True
        return False

    def flip_bit(self, data: bytes, site: str = "store.flip", key: str = "") -> bytes:
        """Return ``data`` with one deterministically chosen bit flipped."""
        self.injected[site] = self.injected.get(site, 0) + 1
        if not data:
            return data
        pos = zlib.crc32(f"{self.plan.seed}|pos|{key}".encode()) % len(data)
        bit = zlib.crc32(f"{self.plan.seed}|bit|{key}".encode()) % 8
        out = bytearray(data)
        out[pos] ^= 1 << bit
        return bytes(out)

    def torn_length(self, n: int, key: str = "") -> int:
        """Deterministic truncation point for a torn write of ``n`` bytes:
        strictly less than ``n`` (something was lost) and at least 1 when
        possible (a zero-byte file is the trivially detected case)."""
        if n <= 1:
            return 0
        return 1 + zlib.crc32(f"{self.plan.seed}|torn|{key}".encode()) % (n - 1)

    def counts(self) -> Dict[str, int]:
        return dict(self.injected)


#: process-global injector; ``None`` = no faults (production)
_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    """The installed injector, or ``None`` — the production fast path."""
    return _ACTIVE


def install(plan: Optional[FaultPlan]) -> Optional[FaultInjector]:
    """Install ``plan`` process-wide (``None`` uninstalls).  Returns the
    injector so the caller can read its counters afterwards."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan) if plan is not None else None
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan) -> Iterator[FaultInjector]:
    """Context manager: install ``plan``, yield the injector, restore the
    previous injector (usually ``None``) on exit."""
    global _ACTIVE
    prev = _ACTIVE
    inj = FaultInjector(plan)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = prev


def without_site(plan: FaultPlan, site: str) -> FaultPlan:
    """A copy of ``plan`` with one site's probability zeroed (scheduled
    entries for the site are kept — they are explicit)."""
    attr = FaultPlan._SITE_P[site]
    return replace(plan, **{attr: 0.0})

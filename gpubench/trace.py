"""The traced run: ``torch.profiler`` with CPU and CUDA activities over a
stretch of the window, the harness's own spans (``record_function``) around
the calls into the program, and what the metrics read from it.

The profiler records a steady stretch inside the window, not all of it, so
that its own cost and the reading of its trace stay small: it warms up at
the first call boundary past a sixth of the window, records from the first
later boundary past a third, and stops at the first boundary ``TRACE_S``
after that, or where the window ends (:class:`Schedule`).  The drivers
mark each call with the phase it ran in, so that the metrics count the
recorded calls alone and the run can show what the profiler cost.

The traced window is the span ``gpubench.window`` around the recorded
calls.  Device operations are the profiler's events on the card but the
device's copies of the harness's spans: its kernels, copies and fills (a
CUDA graph's kernels are traced one by one); the card is busy where at
least one of them runs, on any stream: a union of intervals, never a sum.
Events are read from the profiler's raw results, without building its
per-event Python objects, into arrays: a stretch holds millions of kernels.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the prefix of the harness's spans, and its span of the traced window
SPAN = "gpubench."
WINDOW = SPAN + "window"
#: the recorded stretch: from the first call boundary past ``LEAD`` of the
#: window, for ``TRACE_S`` seconds (at most ``LEAD`` of the window)
LEAD = 1 / 3
TRACE_S = 10.0


class Schedule:
    """What the profiler does at each call boundary of a window of
    ``seconds``: ``prepare`` (warm up; nothing is kept) at the first past
    half of the lead, ``start`` at the first later one past the lead,
    ``stop`` at the first ``span`` seconds after the start.  :meth:`at`
    returns the action and the phase of the call that follows: ``off``,
    ``warm`` or ``on``."""

    def __init__(self, seconds: float):
        self.lead = LEAD * seconds
        self.span = min(TRACE_S, LEAD * seconds)
        self.phase = "off"
        self.started = None
        self.done = False

    def at(self, elapsed: float) -> Tuple[Optional[str], str]:
        action = None
        if self.done:
            pass
        elif self.phase == "off" and elapsed >= self.lead / 2:
            action, self.phase = "prepare", "warm"
        elif self.phase == "warm" and elapsed >= self.lead:
            action, self.phase, self.started = "start", "on", elapsed
        elif self.phase == "on" and elapsed >= self.started + self.span:
            action, self.phase, self.done = "stop", "off", True
        return action, self.phase


class Tracer:
    """With ``enabled``, records the stretch of the window that
    :class:`Schedule` picks; the drivers call :meth:`boundary` before each
    call and :meth:`end` when the window closes.  :meth:`span` is the
    harness's span either way (a no-op untraced)."""

    def __init__(self, enabled: bool, cuda: bool, seconds: float = 0.0):
        self.enabled, self.cuda = enabled, cuda
        self.schedule = Schedule(seconds)
        self.prof = None
        self.window = None
        self.data: Optional[TraceData] = None
        self.read_s: Optional[float] = None   # seconds to stop and read the trace

    def boundary(self, elapsed: float) -> str:
        """The phase of the call that starts ``elapsed`` seconds into the window."""
        if not self.enabled:
            return "off"
        action, phase = self.schedule.at(elapsed)
        if action == "prepare":
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.prepare_trace()
        elif action == "start":
            from torch.profiler import record_function

            self._sync()
            self.prof.start_trace()
            self.window = record_function(WINDOW)
            self.window.__enter__()
        elif action == "stop":
            self._stop()
        return phase

    def end(self) -> None:
        """The window has closed: a recording still open stops here."""
        if self.prof is not None:
            self._stop()

    def _stop(self) -> None:
        self._sync()
        t0 = time.perf_counter()
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.window = None
            self.prof.stop_trace()
            self.data = TraceData.from_profiler(self.prof)
        else:   # only warmed up: a window too short to record keeps nothing
            self.prof.start_trace()
            self.prof.stop_trace()
        self.prof = None
        self.read_s = time.perf_counter() - t0

    def _sync(self) -> None:
        """Every operation queued so far ends before the trace opens or closes."""
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


def phase_rates(calls) -> Dict[str, Dict[str, float]]:
    """Per phase, the calls' count, seconds and tokens a second, from
    ``(phase, seconds, tokens)`` rows: the recorded calls' rate against the
    others' is what the profiler cost."""
    out: Dict[str, Dict[str, float]] = {}
    for phase, seconds, tokens in calls:
        o = out.setdefault(phase, {"calls": 0, "seconds": 0.0, "tokens": 0})
        o["calls"] += 1
        o["seconds"] += seconds
        o["tokens"] += tokens
    for o in out.values():
        o["tokens_per_s"] = o["tokens"] / o["seconds"] if o["seconds"] else None
    return out


class Events:
    """Named intervals in seconds: ``names[idx[i]]`` ran from ``start[i]`` to
    ``end[i]``."""

    def __init__(self, names: List[str], idx, start, end):
        self.names = names
        self.idx = np.asarray(idx, dtype=np.int64)
        self.start = np.asarray(start, dtype=np.float64)
        self.end = np.asarray(end, dtype=np.float64)

    @classmethod
    def of(cls, rows: List[Tuple[str, float, float]]) -> "Events":
        names: Dict[str, int] = {}
        idx = [names.setdefault(n, len(names)) for n, _, _ in rows]
        return cls(list(names), idx, [r[1] for r in rows], [r[2] for r in rows])


class TraceData:
    """Seconds on the profiler's clock: the device's operations, the host's
    events (the harness's spans and the profiler's CPU ops), and the window."""

    def __init__(self, device_ops: Events, host: Events):
        self.device_ops = device_ops
        self.host = host
        w = [i for i, n in enumerate(host.names) if n == WINDOW]
        at = np.nonzero(host.idx == w[0])[0] if w else []
        self.lo, self.hi = (host.start[at[0]], host.end[at[0]]) if len(at) else (0.0, 0.0)

    @classmethod
    def from_profiler(cls, prof) -> "TraceData":
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        rows = ([], [], []), ([], [], [])     # device, host: name index, start, ns
        tables: Tuple[Dict[str, int], Dict[str, int]] = ({}, {})
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            side = 0 if e.device_type() == cuda else 1
            if side == 0 and name.startswith(SPAN):
                continue   # the device's copy of a harness's span: no operation
            table, (idx, start, ns) = tables[side], rows[side]
            idx.append(table.setdefault(name, len(table)))
            start.append(e.start_ns())
            ns.append(e.duration_ns())
        # relative to the first event: epoch nanoseconds in a float would round
        # to a quarter of a microsecond
        base = min((r[1][0] for r in rows if r[1]), default=0)
        dev, host = (Events(list(t), r[0], (np.asarray(r[1], dtype=np.int64) - base) * 1e-9,
                            (np.asarray(r[1], dtype=np.int64) - base + np.asarray(r[2])) * 1e-9)
                     for t, r in zip(tables, rows))
        return cls(dev, host)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @functools.cached_property
    def _clipped(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The device's operations inside the window, clipped to it, by start."""
        d = self.device_ops
        s, e = np.maximum(d.start, self.lo), np.minimum(d.end, self.hi)
        keep = e > s
        order = np.argsort(s[keep], kind="stable")
        return d.idx[keep][order], s[keep][order], e[keep][order]

    @functools.cached_property
    def _idle(self) -> List[Tuple[float, float]]:
        """Stretches of the window with no operation on the device, by start."""
        _, s, e = self._clipped
        if not len(s):
            return [(self.lo, self.hi)] if self.hi > self.lo else []
        reach = np.maximum.accumulate(e)
        starts = np.concatenate([[self.lo], reach])
        ends = np.concatenate([s, [self.hi]])
        open_ = ends > starts
        return list(zip(starts[open_].tolist(), ends[open_].tolist()))

    @property
    def busy_s(self) -> float:
        return self.window_s - sum(g1 - g0 for g0, g1 in self._idle)

    def kernel_seconds(self, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``,
        summed (one kernel at a time: they do not overlap one another)."""
        idx, s, e = self._clipped
        hit = [i for i, n in enumerate(self.device_ops.names) if needle in n]
        return float((e - s)[np.isin(idx, hit)].sum())

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, by name, and the
        longest idle stretches, each named by the harness's span and the
        innermost host op around its middle."""
        idx, s, e = self._clipped
        by_name = np.bincount(idx, weights=e - s, minlength=len(self.device_ops.names))
        ops = [[self.device_ops.names[i], float(by_name[i])] for i in np.argsort(-by_name)[:top]
               if by_name[i] > 0]
        h = self.host
        names = [h.names[i] for i in h.idx]
        out = []
        for g0, g1 in sorted(self._idle, key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (g0 + g1)
            around = np.nonzero((h.start <= mid) & (h.end >= mid))[0]
            spans = [i for i in around if names[i].startswith(SPAN) and names[i] != WINDOW]
            ops_ = [i for i in around if not names[i].startswith(SPAN)]
            span = min(spans, key=lambda i: h.end[i] - h.start[i]) if spans else None
            op = min(ops_, key=lambda i: h.end[i] - h.start[i]) if ops_ else None
            out.append([f"{names[span] if span is not None else 'no span'} / "
                        f"{names[op] if op is not None else 'no op'}", g1 - g0])
        return {"device_ops": ops, "idle_gaps": out}


def idle_share(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the card."""
    t = run.trace
    if t is None or not t.window_s or not len(t.device_ops.idx):
        return None
    return 1.0 - t.busy_s / t.window_s

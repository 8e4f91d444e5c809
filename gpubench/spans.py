"""The program's own spans and counters in a traced run: which of the port's
phases launched the device's work, and what the phases counted.

The port's telemetry (``repro_torch.obs``) records spans around its phases
(the Server's ``serve.prefill``, ``serve.decode``, ``serve.sample`` and
``serve.slot_copy``; the trainer's ``train.forward``, ``train.backward`` and
``train.optimizer``) and counters (``serve.prefill_tokens``,
``serve.decode_rows``, ``serve.busy_rows``).  While a torch profiler records,
each enabled span is also a host op of its name on the profiler's trace, of
function scope: the profiler keeps no device-side copy of it, so the
device's operations are what they are without the spans.

* :class:`ProgramTracer` is the harness's :class:`~gpubench.trace.Tracer`
  that enables the telemetry only while the profiler records, keeps its
  counters at the stop, and reads the trace once into the harness's
  :class:`~gpubench.trace.TraceData` (the same arrays as
  ``TraceData.from_profiler``) and each device operation's launch: the start
  of the host's runtime call (``cudaLaunchKernel``, ``cudaGraphLaunch``,
  ``cudaMemcpyAsync``, ...) whose correlation id the operation carries.
* :func:`device_seconds` sums, per program span, the device seconds of the
  operations launched inside it, on any thread (autograd launches the
  backward from a thread of its own), clipped to the traced window as
  ``TraceData.kernel_seconds`` is; where spans nest, the innermost one gets
  the time.
* :func:`idle_gaps` names each idle gap by the harness's span, the innermost
  program span around its middle (where one covers it), and the innermost
  host op: ``gpubench.serve / serve.sample / cudaMemcpyAsync``.
* :func:`readings` gives the per-layer numbers these support.

Run a cell traced with this tracer (``run.py``'s arguments; ``--trace 1`` is
implied), its ``gpubench.spans`` line printed after ``run.py``'s::

    python3 gpubench/spans.py --workload <cell> --seed <n> --seconds <s> [--rehearse]

``run.py`` itself keeps the harness's own ``Tracer``, which leaves the
telemetry off, so no metric of ``BENCHMARK.json`` reads this file yet.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import trace  # noqa: E402

#: the program's phases, whose spans between them should hold the device's work
SERVE_PHASES = ("serve.prefill", "serve.decode", "serve.sample", "serve.slot_copy",
                "graph.capture")
TRAIN_PHASES = ("train.forward", "train.backward", "train.optimizer")
#: the harness's span around one training step
STEP = trace.SPAN + "step"


def read_profiler(prof, program: Iterable[str] = ()) -> Tuple[trace.TraceData, np.ndarray]:
    """The trace as ``trace.TraceData.from_profiler`` reads it, and, aligned
    with its device operations, each one's launch in seconds on the same
    clock (NaN where no runtime call of its correlation id was recorded).
    A device-side copy of a span named in ``program`` is dropped as the
    harness's own are: it is no operation."""
    from torch.autograd import DeviceType

    cuda, program = DeviceType.CUDA, frozenset(program)
    rows = ([], [], []), ([], [], [])     # device, host: name index, start, ns
    tables: Tuple[Dict[str, int], Dict[str, int]] = ({}, {})
    corr: List[int] = []                  # each device operation's correlation id
    launched: Dict[int, int] = {}         # correlation id -> its runtime call's start
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        side = 0 if e.device_type() == cuda else 1
        if side == 0:
            if name.startswith(trace.SPAN) or name in program:
                continue
            corr.append(e.correlation_id())
        elif runtime_call(name):
            launched[e.correlation_id()] = e.start_ns()
        table, (idx, start, ns) = tables[side], rows[side]
        idx.append(table.setdefault(name, len(table)))
        start.append(e.start_ns())
        ns.append(e.duration_ns())
    # relative to the first event, as TraceData.from_profiler counts
    base = min((r[1][0] for r in rows if r[1]), default=0)
    dev, host = (trace.Events(list(t), r[0],
                              (np.asarray(r[1], dtype=np.int64) - base) * 1e-9,
                              (np.asarray(r[1], dtype=np.int64) - base + np.asarray(r[2])) * 1e-9)
                 for t, r in zip(tables, rows))
    launch = np.array([(launched[c] - base) * 1e-9 if c in launched else math.nan for c in corr],
                      dtype=np.float64)
    return trace.TraceData(dev, host), launch


def runtime_call(name: str) -> bool:
    """Whether a host event is a call into the CUDA runtime (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...) or its lower-level API
    (``cuLaunchKernel``): the operations such a call launches carry its
    correlation id."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


class ProgramTracer(trace.Tracer):
    """The harness's tracer with the program's telemetry on while the
    profiler records: reset and enabled when the recording starts; at the
    stop its counters are kept (``counters``), then it is disabled and reset.
    ``launch`` holds each device operation's launch (:func:`read_profiler`)
    and ``program`` the names of the spans the program recorded."""

    def __init__(self, enabled: bool, cuda: bool, seconds: float = 0.0):
        super().__init__(enabled, cuda, seconds)
        self.launch: Optional[np.ndarray] = None
        self.counters: Dict[str, object] = {}
        self.program: List[str] = []

    def boundary(self, elapsed: float) -> str:
        from repro_torch import obs

        phase = super().boundary(elapsed)
        if self.window is not None and not obs.enabled():    # the recording has started
            obs.reset()
            obs.enable()
        return phase

    def _stop(self) -> None:
        from repro_torch import obs

        self._sync()
        t0 = time.perf_counter()
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.window = None
            self.prof.stop_trace()
            self.counters = obs.metrics().snapshot()
            self.program = sorted({r.name for r in obs.get_telemetry().events})
            obs.disable()
            obs.reset()
            self.data, self.launch = read_profiler(self.prof, self.program)
        else:   # only warmed up: a window too short to record keeps nothing
            self.prof.start_trace()
            self.prof.stop_trace()
        self.prof = None
        self.read_s = time.perf_counter() - t0


def _host_rows(data: trace.TraceData, names: Iterable[str]) -> np.ndarray:
    """Indices of the host events named in ``names``."""
    h, names = data.host, set(names)
    want = [i for i, n in enumerate(h.names) if n in names]
    return np.nonzero(np.isin(h.idx, want))[0]


def device_seconds(data: trace.TraceData, launch: np.ndarray,
                   program: Iterable[str]) -> Dict[str, float]:
    """Per program span name, the device seconds (clipped to the window,
    summed) of the operations launched inside one of its spans, the
    innermost where spans nest; under ``"outside"`` those launched in none
    of them, and under ``"unmatched"`` those whose launch was not recorded."""
    d, h = data.device_ops, data.host
    s, e = np.maximum(d.start, data.lo), np.minimum(d.end, data.hi)
    keep = e > s
    dur, at = (e - s)[keep], launch[keep]
    out = {"unmatched": float(dur[np.isnan(at)].sum())}
    dur, at = dur[~np.isnan(at)], at[~np.isnan(at)]
    order = np.argsort(at, kind="stable")
    dur, at = dur[order], at[order]
    owner = np.full(len(at), -1, dtype=np.int64)
    rows = _host_rows(data, program)
    for i in rows[np.argsort(-(h.end[rows] - h.start[rows]), kind="stable")]:
        # longest first: a shorter span inside it takes its launches after
        owner[np.searchsorted(at, h.start[i], "left"):np.searchsorted(at, h.end[i], "right")] = \
            h.idx[i]
    sums = np.bincount(owner + 1, weights=dur, minlength=len(h.names) + 1)
    out["outside"] = float(sums[0])
    for k in sorted(set(h.idx[rows].tolist())):
        out[h.names[k]] = float(sums[k + 1])
    return out


def span_counts(data: trace.TraceData, names: Iterable[str]) -> Dict[str, int]:
    """How many spans of each of ``names`` start inside the traced window."""
    h = data.host
    rows = _host_rows(data, names)
    rows = rows[(h.start[rows] >= data.lo) & (h.start[rows] <= data.hi)]
    return {h.names[k]: int(c) for k, c in zip(*np.unique(h.idx[rows], return_counts=True))}


def idle_gaps(data: trace.TraceData, program: Iterable[str], top: int = 10) -> List[List]:
    """The longest idle stretches of ``TraceData.breakdown``, each named by
    the harness's span, the innermost program span around its middle where
    one covers it, and the innermost other host op."""
    h, program = data.host, set(program)
    names = [h.names[i] for i in h.idx]
    out = []
    for g0, g1 in sorted(data._idle, key=lambda g: g[0] - g[1])[:top]:   # the breakdown's gaps
        mid = 0.5 * (g0 + g1)
        around = np.nonzero((h.start <= mid) & (h.end >= mid))[0]
        parts = []
        for pick in (lambda n: n.startswith(trace.SPAN) and n != trace.WINDOW,
                     lambda n: n in program,
                     lambda n: not n.startswith(trace.SPAN) and n not in program):
            hit = [i for i in around if pick(names[i])]
            parts.append(names[min(hit, key=lambda i: h.end[i] - h.start[i])] if hit else None)
        harness, span, op = parts
        out.append([" / ".join([harness or "no span"] + ([span] if span else [])
                               + [op or "no op"]), g1 - g0])
    return out


def readings(data: trace.TraceData, launch: np.ndarray, program: Iterable[str],
             counters: Dict[str, object]) -> Dict[str, object]:
    """The per-layer numbers the program's spans and counters support, and
    what they are made of.  A number the trace cannot give (no device
    operation: a CPU run) is None; a counter's share needs no device."""
    program = sorted(program)
    counts = span_counts(data, program + [STEP])
    busy = data.busy_s if len(data.device_ops.idx) else None
    dev = device_seconds(data, launch, program) if busy else {}
    out: Dict[str, object] = {}

    def per(span: str, count, scale: float):
        return scale * dev[span] / count if busy and count and span in dev else None

    if "serve" in program:
        rows = counters.get("serve.decode_rows")
        out["server.prefill_us_per_token"] = per("serve.prefill",
                                                 counters.get("serve.prefill_tokens"), 1e6)
        out["server.decode_ms_per_step"] = per("serve.decode", counts.get("serve.decode"), 1e3)
        out["server.slot_copy_share"] = per("serve.slot_copy", busy, 1.0)
        out["server.slot_use"] = counters["serve.busy_rows"] / rows if rows else None
        phases = SERVE_PHASES
    elif "train.forward" in program:
        steps = counts.get(STEP)
        for span in TRAIN_PHASES:
            out[f"trainer.{span.split('.')[1]}_ms_per_step"] = per(span, steps, 1e3)
        phases = TRAIN_PHASES
    else:
        phases = ()
    out["phases_cover_busy"] = (sum(dev.get(p, 0.0) for p in phases) / busy) if busy else None
    return {"metrics": out, "device_s": dev,
            "busy_s": busy, "spans": counts, "counters": counters,
            "idle_gaps": idle_gaps(data, program) if busy else []}


def main(argv=None) -> int:
    """``run.py`` on the cell with :class:`ProgramTracer`, then one line:
    ``gpubench.spans`` and :func:`readings` as JSON."""
    from gpubench import run as bench_run

    made: List[ProgramTracer] = []

    def tracer(*args, **kw):
        made.append(ProgramTracer(*args, **kw))
        return made[-1]

    harness_tracer, trace.Tracer = trace.Tracer, tracer
    try:
        rc = bench_run.main(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])
    finally:
        trace.Tracer = harness_tracer
    t = made[-1] if made else None
    if rc or t is None or t.data is None:
        print("gpubench.spans: the run recorded no trace", file=sys.stderr)
        return rc or 3
    out = readings(t.data, t.launch, t.program, t.counters)
    out["read_s"] = t.read_s
    print("gpubench.spans " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

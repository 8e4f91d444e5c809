"""Telemetry exporters: JSONL event log and Chrome trace-format.

Two machine-readable renderings of one span timeline:

* :func:`to_jsonl` — one JSON object per line per span (plus one trailing
  ``{"kind": "metrics", ...}`` line with the registry snapshot), the
  greppable/streamable archive format;
* :func:`chrome_trace` — the Chrome trace-event format (``"X"`` complete
  events, microsecond timestamps) that loads directly into
  ``chrome://tracing`` or https://ui.perfetto.dev.  Spans recorded in
  pool workers carry their own ``pid`` and render as separate process rows
  under the parent timeline.

:func:`write_trace` dispatches on extension: ``.jsonl`` writes the event
log, anything else writes Chrome trace JSON.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from .telemetry import DEFAULT_TELEMETRY, SpanRecord, Telemetry


def _sorted_events(events: Sequence[SpanRecord]) -> List[SpanRecord]:
    """Deterministic order: by process, thread, then monotonic open time."""
    return sorted(events, key=lambda e: (e.pid, e.tid, e.ts, e.span_id))


def to_jsonl(telemetry: Optional[Telemetry] = None) -> str:
    """The span timeline (+ metrics snapshot) as JSON-lines text."""
    tel = telemetry if telemetry is not None else DEFAULT_TELEMETRY
    lines = [
        json.dumps({"kind": "span", **e.to_json()}, sort_keys=True)
        for e in _sorted_events(tel.events)
    ]
    lines.append(
        json.dumps(
            {"kind": "metrics", "metrics": tel.registry.snapshot()}, sort_keys=True
        )
    )
    return "\n".join(lines) + "\n"


def chrome_trace(telemetry: Optional[Telemetry] = None) -> dict:
    """The span timeline as a Chrome trace-event object.

    Timestamps are microseconds rebased to the earliest span (Perfetto
    dislikes raw multi-hour perf_counter offsets); events are complete
    (``"ph": "X"``) spans sorted by (pid, tid, ts), so ``ts`` is monotonic
    within every row and ``dur`` is never negative.
    """
    tel = telemetry if telemetry is not None else DEFAULT_TELEMETRY
    events = _sorted_events(tel.events)
    t0 = min((e.ts for e in events), default=0.0)
    trace_events = [
        {
            "name": e.name,
            "ph": "X",
            "ts": round((e.ts - t0) * 1e6, 3),
            "dur": round(max(e.dur, 0.0) * 1e6, 3),
            "pid": e.pid,
            "tid": e.tid,
            "args": {str(k): v for k, v in sorted(e.attrs.items())},
        }
        for e in events
    ]
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"spans": len(trace_events), "source": "repro_torch.obs"},
    }


def write_trace(path: str, telemetry: Optional[Telemetry] = None) -> str:
    """Write the timeline to ``path``; format chosen by extension
    (``.jsonl`` -> JSON-lines event log, else Chrome trace JSON).
    Returns the format written (``"jsonl"`` or ``"chrome"``)."""
    if path.endswith(".jsonl"):
        payload = to_jsonl(telemetry)
        fmt = "jsonl"
    else:
        payload = json.dumps(chrome_trace(telemetry), sort_keys=True) + "\n"
        fmt = "chrome"
    with open(path, "w") as fh:
        fh.write(payload)
    return fmt

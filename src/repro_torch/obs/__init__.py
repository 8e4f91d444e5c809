"""repro_torch.obs — the port's own copy of the unified telemetry layer.

One process-wide subsystem, near-zero overhead when disabled:

* :mod:`repro_torch.obs.telemetry`  hierarchical spans (name, wall time,
                                    attrs, parent), pool-worker export/merge;
* :mod:`repro_torch.obs.metrics`    counters / gauges / histograms (p50/p99)
                                    in a snapshot-able registry;
* :mod:`repro_torch.obs.stallprof`  per-instruction, per-reason stall
                                    attribution from the event-driven SASS
                                    simulator (books balance exactly against
                                    ``SimResult.issue_stalls``);
* :mod:`repro_torch.obs.export`     JSONL event log + Chrome trace-format
                                    (``chrome://tracing`` / Perfetto) exporters.

It mirrors ``repro.obs`` file for file and imports nothing of it, so the port
runs where the JAX package is absent.

Typical use::

    from repro_torch import obs

    obs.enable()
    ... serve requests / run translations ...
    obs.write_trace("trace.json")          # load in Perfetto
    print(obs.metrics().snapshot())

Instrumentation sites call ``obs.span(...)`` unconditionally: with
telemetry disabled that is one attribute check returning a shared no-op.
"""

from .export import chrome_trace, to_jsonl, write_trace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, hit_rate
from .stallprof import REASONS, InstrStall, StallProfile, build_profile
from .telemetry import (
    DEFAULT_TELEMETRY,
    NULL_SPAN,
    Span,
    SpanRecord,
    Telemetry,
    disable,
    enable,
    enabled,
    get_telemetry,
    metrics,
    reset,
    span,
)

__all__ = [
    "chrome_trace",
    "to_jsonl",
    "write_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "hit_rate",
    "REASONS",
    "InstrStall",
    "StallProfile",
    "build_profile",
    "DEFAULT_TELEMETRY",
    "NULL_SPAN",
    "Span",
    "SpanRecord",
    "Telemetry",
    "disable",
    "enable",
    "enabled",
    "get_telemetry",
    "metrics",
    "reset",
    "span",
]

"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of the reference package's metrics vocabulary (same
classes, same snapshot schema), kept here so that the port imports nothing
of the JAX package:

* :class:`Counter`    monotonically increasing count (cache hits, passes run);
* :class:`Gauge`      last-written value (entries resident, capacity);
* :class:`Histogram`  bounded-reservoir distribution with p50/p99
                      (translate latency, pass wall time);
* :class:`MetricsRegistry`  named get-or-create store, snapshot-able as one
                      plain dict (what ``Server.metrics_snapshot`` and a
                      metrics endpoint serve).

Everything here is stdlib-only and import-light.  Updates are a few dict
operations — cheap enough to stay always-on at call granularity; anything
finer stays behind :func:`repro_torch.obs.telemetry.enabled`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union


def hit_rate(
    hits: int, misses: int, default: Optional[float] = None
) -> float:
    """The one shared hits/(hits+misses) implementation.

    Every cache's hit rate delegates here so the formula can never drift
    apart.  A zero-access denominator has no meaningful
    rate: that raises an explicit :class:`ValueError` — never a bare
    ``ZeroDivisionError`` from deep inside a report — unless the caller
    opts into a ``default`` (display/stats paths pass ``default=0.0``;
    decision paths should let the error surface).
    """
    total = hits + misses
    if not total:
        if default is None:
            raise ValueError(
                "hit rate undefined: no cache accesses recorded "
                "(pass default= for display paths)"
            )
        return default
    return hits / total


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge for levels")
        self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-written value (a level, not a rate)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Distribution with exact count/sum/min/max and reservoir percentiles.

    Keeps the most recent ``max_samples`` observations (a ring, so a
    long-running service reports *current* latency, not its lifetime
    average) while ``count``/``total`` stay exact over every observation.
    """

    __slots__ = ("max_samples", "count", "total", "vmin", "vmax", "_ring", "_pos")

    def __init__(self, max_samples: int = 2048) -> None:
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._ring: List[float] = []
        self._pos = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value
        if len(self._ring) < self.max_samples:
            self._ring.append(value)
        else:
            self._ring[self._pos] = value
            self._pos = (self._pos + 1) % self.max_samples

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the resident reservoir (0 if empty)."""
        if not self._ring:
            return 0.0
        ordered = sorted(self._ring)
        rank = min(len(ordered) - 1, max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
        return ordered[rank]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": round(self.mean, 6),
            "min": self.vmin or 0.0,
            "max": self.vmax or 0.0,
            "p50": round(self.percentile(50), 6),
            "p99": round(self.percentile(99), 6),
        }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named get-or-create metric store, snapshot-able as one plain dict."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def __len__(self) -> int:
        return len(self._metrics)

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not a {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def clear(self) -> None:
        self._metrics.clear()

    def snapshot(self) -> Dict[str, object]:
        """Every metric as plain JSON-able values, sorted by name."""
        return {name: self._metrics[name].snapshot() for name in sorted(self._metrics)}

    # -- pool-worker exchange ---------------------------------------------------

    def export(self) -> Dict[str, tuple]:
        """Picklable payload for :meth:`merge` (pool workers measure into a
        private registry and ship the deltas back on join)."""
        out: Dict[str, tuple] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                out[name] = ("counter", m.value)
            elif isinstance(m, Gauge):
                out[name] = ("gauge", m.value)
            else:
                out[name] = ("histogram", m.count, m.total, m.vmin, m.vmax, list(m._ring))
        return out

    def merge(self, exported: Dict[str, tuple]) -> None:
        """Adopt an :meth:`export` payload: counters add, gauges last-write,
        histogram observations replay (deterministic given deterministic
        payload order — callers merge in submission order)."""
        for name in sorted(exported):
            payload = exported[name]
            kind = payload[0]
            if kind == "counter":
                self.counter(name).inc(payload[1])
            elif kind == "gauge":
                self.gauge(name).set(payload[1])
            else:
                h = self.histogram(name)
                _, count, total, vmin, vmax, ring = payload
                for v in ring:
                    h.observe(v)
                # replaying the ring undercounts trimmed observations;
                # restore the exact lifetime count/sum/extrema
                h.count += count - len(ring)
                h.total += total - sum(ring)
                if vmin is not None and (h.vmin is None or vmin < h.vmin):
                    h.vmin = vmin
                if vmax is not None and (h.vmax is None or vmax > h.vmax):
                    h.vmax = vmax

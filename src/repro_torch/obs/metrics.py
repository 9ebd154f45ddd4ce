"""Process-local metrics registry: counters + bounded histograms.

Instrumented code grabs an instrument lazily by name —
``REGISTRY.counter("cache.hits").inc()`` — so the registry's contents
reflect exactly what the run exercised.  Histograms keep a fixed-size
deterministic reservoir (first :data:`Histogram.SAMPLE` observations,
then a modular ring) so quantile estimates cost O(1) memory no matter
how hot the path is.

The registry is observational only: nothing in certificates, goldens,
or stable summaries reads it.  ``launch/verify.py --metrics`` prints
:func:`render` to stderr and adds :meth:`MetricsRegistry.snapshot` to
the JSON envelope under the ``metrics`` key (only under the flag, so
the schema-v2 key set stays pinned otherwise).

Metric name inventory (the JAX package's, ``docs/OBSERVABILITY.md``):
``engine.runs``, ``engine.lemma_fires``, ``engine.infer_s``,
``engine.egraph_nodes``, ``engine.frontier_ready``, ``pool.tasks``,
``pool.queue_s``, ``pool.run_s``, ``pool.retries``, ``pool.timeouts``,
``pool.broken``, ``pool.degraded``, ``cache.hits``, ``cache.misses``,
``cache.commits``, ``chaos.injected``; and the port's training and
serving path's, under ``obs.trace.device_ranges`` (README.md, "Port CLI
reference", "Device ranges"): ``moe.rows_routed``, ``moe.rows_kept``,
``moe.slots``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union


class Counter:
    """A monotonically increasing named count. An increment may be a 0-d
    device tensor: the count then stays on the device, summed there,
    until :meth:`MetricsRegistry.snapshot` reads it."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1) to the counter."""
        self.value += n


class Histogram:
    """Summary statistics over observed values with a bounded reservoir.

    Tracks exact count/sum/min/max; p50/p95 come from a deterministic
    sample (first ``SAMPLE`` values, then overwrite at ``count % SAMPLE``)
    so snapshots are reproducible for a given observation sequence.
    """

    SAMPLE = 256

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_sample")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._sample: list = []

    def observe(self, value: float) -> None:
        """Record one observation."""
        value = float(value)
        if len(self._sample) < self.SAMPLE:
            self._sample.append(value)
        else:
            self._sample[self.count % self.SAMPLE] = value
        self.count += 1
        self.total += value
        self.vmin = value if self.vmin is None else min(self.vmin, value)
        self.vmax = value if self.vmax is None else max(self.vmax, value)

    def _quantile(self, q: float) -> float:
        s = sorted(self._sample)
        return s[min(int(q * len(s)), len(s) - 1)]

    def snapshot(self) -> dict:
        """JSON-ready summary: count/sum/mean/min/max/p50/p95."""
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(self.total / self.count, 6),
            "min": round(self.vmin, 6),
            "max": round(self.vmax, 6),
            "p50": round(self._quantile(0.50), 6),
            "p95": round(self._quantile(0.95), 6),
        }


class MetricsRegistry:
    """Name-keyed collection of counters and histograms."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        """Get (or create) the counter called ``name``."""
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def histogram(self, name: str) -> Histogram:
        """Get (or create) the histogram called ``name``."""
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> dict:
        """JSON-ready view of every instrument, sorted by name."""
        return {
            "counters": {k: _number(self._counters[k].value)
                         for k in sorted(self._counters)},
            "histograms": {k: self._histograms[k].snapshot()
                           for k in sorted(self._histograms)},
        }

    def reset(self) -> None:
        """Drop every instrument (used at the start of a ``--metrics`` run
        so the report covers exactly that invocation)."""
        self._counters.clear()
        self._histograms.clear()


REGISTRY = MetricsRegistry()


def _number(value):
    """A count as a Python number (a device tensor's is read once)."""
    return value if isinstance(value, (int, float)) else value.item()


def render(snapshot: Optional[Union[dict, MetricsRegistry]] = None) -> str:
    """Human-readable table of a registry snapshot (default: the global)."""
    if snapshot is None:
        snapshot = REGISTRY
    if isinstance(snapshot, MetricsRegistry):
        snapshot = snapshot.snapshot()
    lines = ["-- metrics --"]
    counters = snapshot.get("counters", {})
    for name in sorted(counters):
        lines.append(f"{name:<28} {counters[name]}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        if not h.get("count"):
            continue
        lines.append(
            f"{name:<28} n={h['count']} sum={h['sum']:.4g} "
            f"mean={h['mean']:.4g} p50={h['p50']:.4g} "
            f"p95={h['p95']:.4g} max={h['max']:.4g}")
    if len(lines) == 1:
        lines.append("(no metrics recorded)")
    return "\n".join(lines)

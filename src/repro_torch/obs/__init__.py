"""``repro_torch.obs`` — dependency-free tracing + metrics for the verifier.

The part of the JAX package's ``repro.obs`` that the engine uses:

* :mod:`repro_torch.obs.trace` — a :class:`Tracer` recording nested spans,
  instant events and counter samples per process as Chrome/Perfetto trace
  events (:meth:`Tracer.chrome_trace`); :func:`span` is a no-op when no
  tracer is installed. Its export to files and the trace inspector are
  not ported yet (ROADMAP queue 1, item 9).
* :mod:`repro_torch.obs.metrics` — a process-local registry of counters and
  bounded histograms (lemma fires, e-graph growth, frontier sizes).

Observability is behaviour-neutral: certificates and stable summaries are
the same with tracing on or off.
"""
from . import metrics
from .metrics import REGISTRY
from .trace import (Tracer, counter, current, event, install, span, start,
                    stop)

__all__ = [
    "Tracer", "start", "stop", "current", "install",
    "span", "event", "counter",
    "metrics", "REGISTRY",
]

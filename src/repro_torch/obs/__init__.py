"""``repro_torch.obs`` — dependency-free tracing + metrics for the verifier.

Two independent facilities, both zero-cost when idle:

* :mod:`repro_torch.obs.trace` — a :class:`Tracer` recording nested spans,
  instant events and counter samples per process, merged across
  ``SupervisedPool`` workers through the pool's ``Manager`` plumbing, and
  exported as a Chrome/Perfetto ``trace.json`` plus a JSONL event log.
* :mod:`repro_torch.obs.metrics` — a process-local registry of counters and
  bounded histograms (lemma fires, e-graph growth, queue wait vs run wall,
  cache hit ratio, retry/degradation counts).

Inspection: ``python -m repro_torch.obs report trace.json`` renders the top
lemmas by time, the slowest tasks with their queue-vs-run split, a
per-worker pool timeline, cache savings and any fault events.

Observability is behaviour-neutral: certificates and stable summaries are
the same with tracing on or off, and the package is left out of the
certificate cache's engine fingerprint.
"""
from . import metrics
from .metrics import REGISTRY
from .trace import (Tracer, complete, counter, current, event, install,
                    span, start, stop)

__all__ = [
    "Tracer", "start", "stop", "current", "install",
    "span", "event", "counter", "complete",
    "metrics", "REGISTRY",
]

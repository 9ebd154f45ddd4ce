"""Structured tracing: nested spans + instant events, Chrome-exportable.

One :class:`Tracer` per process.  Spans are recorded as Chrome trace
"complete" events (``ph: "X"``) with microsecond epoch timestamps; all
timestamps inside a process derive from a single ``(epoch, perf_counter)``
anchor captured at tracer construction, so span nesting within a thread
is well-formed by construction (no clock mixing).  Appends go straight
to a plain list — atomic under the GIL, no locks on the hot path.

Cross-process merging: ``SupervisedPool`` workers install their own
tracer inside the worker shim, wrap the task in a ``task`` span, and
ship the event batch back through the pool's existing ``Manager``
plumbing; the parent tracer :meth:`Tracer.absorb`\\ s them, keeping each
worker's real ``pid`` so the Perfetto timeline shows one track per
worker process.

Module-level :func:`span` / :func:`event` / :func:`counter` /
:func:`complete` dispatch to the installed tracer and are no-ops (a
shared null context manager / an early return) when tracing is off —
instrumented code never needs an ``if`` guard.

Chrome trace event format reference:
https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, List, Optional

_TLS = threading.local()


class _NullSpan:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one nested span on a :class:`Tracer`.

    ``__enter__`` pushes onto a thread-local stack (the depth becomes a
    span attribute); ``__exit__`` pops and emits a single ``X`` event.
    """

    __slots__ = ("tracer", "name", "cat", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = _TLS.stack
        stack.pop()
        args = dict(self.attrs)
        args["depth"] = len(stack)
        self.tracer._emit_x(self.name, self.cat, self._t0, t1, args)
        return False


class Tracer:
    """Per-process span/event recorder with Chrome + JSONL export.

    All events carry epoch-derived microsecond timestamps computed from
    one ``(base_epoch, base_perf)`` anchor, so spans recorded in this
    process nest consistently and merge onto a shared timeline with
    events absorbed from other processes (whose anchors are their own —
    wall clocks on one machine agree to well under typical span widths).
    """

    def __init__(self, process: str = "main"):
        self.process = process
        self.pid = os.getpid()
        self.events: List[dict] = []
        self._base_epoch = time.time()
        self._base_perf = time.perf_counter()
        # Perfetto track naming: one metadata event per producing process.
        self.events.append({"name": "process_name", "ph": "M", "ts": 0.0,
                            "pid": self.pid, "tid": 0,
                            "args": {"name": process}})

    # -- timestamp plumbing -------------------------------------------------
    def _epoch_us(self, perf_t: float) -> float:
        return (self._base_epoch + (perf_t - self._base_perf)) * 1e6

    def _emit_x(self, name: str, cat: str, t0: float, t1: float,
                args: dict) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": round(self._epoch_us(t0), 3),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": self.pid, "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": args})

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "engine", **attrs: Any) -> _Span:
        """Open a nested span; closes (and records) on ``with`` exit."""
        return _Span(self, name, cat, attrs)

    def event(self, name: str, cat: str = "engine", **attrs: Any) -> None:
        """Record an instant event (Chrome ``ph: "i"``)."""
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "p",
            "ts": round(self._epoch_us(time.perf_counter()), 3),
            "pid": self.pid, "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": attrs})

    def counter(self, name: str, cat: str = "metric",
                **values: float) -> None:
        """Record a Chrome counter sample (``ph: "C"``) — e.g. e-graph
        nodes/classes over time, rendered as a stacked area in Perfetto."""
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": round(self._epoch_us(time.perf_counter()), 3),
            "pid": self.pid, "tid": 0, "args": values})

    def span_from(self, name: str, t0_perf: float, t1_perf: float,
                  cat: str = "engine", **attrs: Any) -> None:
        """Record a span from explicit ``perf_counter`` endpoints — for
        code that already times itself (e.g. the engine's phase timers)."""
        self._emit_x(name, cat, t0_perf, t1_perf, dict(attrs))

    def complete(self, name: str, start_epoch_s: float, end_epoch_s: float,
                 cat: str = "pool", **attrs: Any) -> None:
        """Record a span from explicit epoch endpoints.

        Used by the pool supervisor to reconstruct per-task ``queue`` and
        ``run`` intervals from its bookkeeping (submit time, heartbeat
        start, completion) — these wall-clock spans live on the parent
        timeline and are exempt from the perf-anchored nesting guarantee.
        """
        if end_epoch_s < start_epoch_s:
            start_epoch_s = end_epoch_s
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": round(start_epoch_s * 1e6, 3),
            "dur": round((end_epoch_s - start_epoch_s) * 1e6, 3),
            "pid": self.pid, "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": attrs})

    def absorb(self, events: List[dict]) -> None:
        """Merge an event batch shipped from another process (worker pids
        are preserved, giving each worker its own Perfetto track)."""
        self.events.extend(events)

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The Chrome/Perfetto ``trace.json`` object (displayTimeUnit ms)."""
        evs = sorted(self.events,
                     key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        """Write the Chrome/Perfetto trace JSON to ``path`` (gzipped when
        the path ends in ``.gz`` — Perfetto loads those directly)."""
        with _open_text(path, "wt") as f:
            json.dump(self.chrome_trace(), f)

    def write_jsonl(self, path: str) -> None:
        """Write one event per line (ts-sorted) — the grep-friendly log
        (``zcat``-friendly when the path ends in ``.gz``)."""
        evs = sorted((e for e in self.events if e.get("ph") != "M"),
                     key=lambda e: e.get("ts", 0.0))
        with _open_text(path, "wt") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")


def _open_text(path: str, mode: str):
    """Text-mode open that is transparent to a ``.gz`` suffix."""
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, mode)
    return open(path, mode.rstrip("t") or "r")


# -- module-level dispatch (no-op when no tracer installed) -----------------
_ACTIVE: Optional[Tracer] = None


def current() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is off."""
    return _ACTIVE


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process tracer; returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def start(process: str = "main") -> Tracer:
    """Create and install a fresh :class:`Tracer` for this process."""
    tracer = Tracer(process)
    install(tracer)
    return tracer


def stop() -> Optional[Tracer]:
    """Uninstall and return the active tracer (idempotent)."""
    return install(None)


def span(name: str, cat: str = "engine", **attrs: Any):
    """Span on the installed tracer; shared null context when off."""
    t = _ACTIVE
    return _NULL_SPAN if t is None else t.span(name, cat, **attrs)


def event(name: str, cat: str = "engine", **attrs: Any) -> None:
    """Instant event on the installed tracer; no-op when off."""
    t = _ACTIVE
    if t is not None:
        t.event(name, cat, **attrs)


def counter(name: str, cat: str = "metric", **values: float) -> None:
    """Counter sample on the installed tracer; no-op when off."""
    t = _ACTIVE
    if t is not None:
        t.counter(name, cat, **values)


def complete(name: str, start_epoch_s: float, end_epoch_s: float,
             cat: str = "pool", **attrs: Any) -> None:
    """Explicit-endpoint span on the installed tracer; no-op when off."""
    t = _ACTIVE
    if t is not None:
        t.complete(name, start_epoch_s, end_epoch_s, cat, **attrs)


def load_events(path: str) -> List[dict]:
    """Load events from a ``trace.json`` (Chrome object) or ``.jsonl`` log.

    Accepts either export format (gzipped or not — a ``.gz`` suffix is
    decompressed transparently) so ``repro_torch.obs report`` works on all.
    """
    with _open_text(path, "rt") as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:         # more than one line: JSONL
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]
    if isinstance(obj, dict) and "traceEvents" in obj:
        return list(obj["traceEvents"])
    return [obj] if isinstance(obj, dict) else list(obj)

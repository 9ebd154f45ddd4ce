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

Device ranges: under :func:`device_ranges` every :func:`span` is also a
``torch.profiler.record_function`` range, so a ``torch.profiler`` session
puts the program's spans on the kernels' clock (each range's kernels sit
under it in the trace, and the profiler draws it on the device's timeline
too). :func:`backward_range` marks a region's backward the same way: an
identity autograd Function on the region's outputs opens ``<name>`` in
the backward, one on its inputs closes it. The training and serving path
names its spans with :data:`PREFIX`, so a reader tells them from kernels.
Off (the default), a span stays one global read and a marker returns its
tensors as given, adding no autograd node; torch is imported only once
the switch is on. The spans and counters are listed in README.md, "Port
CLI reference", "Device ranges".

Chrome trace event format reference:
https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import contextlib
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
_RANGES = False      # device_ranges(): spans are profiler ranges too
_ON = False          # _ACTIVE is not None or _RANGES: span()'s one read


def current() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is off."""
    return _ACTIVE


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process tracer; returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    _refresh()
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
    """Span on the installed tracer, and a profiler range under
    :func:`device_ranges`; shared null context when both are off."""
    if not _ON:
        return _NULL_SPAN
    t = _ACTIVE
    inner = None if t is None else t.span(name, cat, **attrs)
    return _Range(name, inner) if _RANGES else inner


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


# -- device ranges: the program's spans on the profiler's clock -------------
PREFIX = "rt."       # every span of the training and serving path
_OPEN: dict = {}     # backward ranges opened and not yet closed, by id


@contextlib.contextmanager
def device_ranges():
    """Within the block, every :func:`span` is also a profiler range and
    :func:`backward_range` marks backwards; the previous state comes back
    on exit, an error's included. The outermost block closes the backward
    ranges left open (a close marker whose backward never ran) and, on a
    clean exit, raises ``RuntimeError`` naming them."""
    global _RANGES
    prev = _RANGES
    _RANGES = True
    _refresh()
    try:
        yield
    finally:
        _RANGES = prev
        _refresh()
        left = []
        if not prev:
            left = open_backward_ranges()
            for r in list(_OPEN.values()):
                r.close()
    if left:
        raise RuntimeError(f"backward ranges opened and never closed: {left}")


def _refresh():
    global _ON
    _ON = _ACTIVE is not None or _RANGES


def ranges_on() -> bool:
    """Whether :func:`device_ranges` is on."""
    return _RANGES


def open_backward_ranges() -> List[str]:
    """The names of the backward ranges opened and not yet closed."""
    return sorted(r.name for r in _OPEN.values())


def _record_function(name: str):
    from torch.profiler import record_function
    return record_function(name)


class _Range:
    """A span that is also a profiler range (and, with a tracer installed,
    the tracer's span ``inner``)."""

    __slots__ = ("name", "inner", "rf")

    def __init__(self, name: str, inner):
        self.name, self.inner = name, inner

    def __enter__(self):
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        if self.inner is not None:
            self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        if self.inner is not None:
            self.inner.__exit__(*exc)
        self.rf.__exit__(*exc)
        return False


def _as_given(ts):
    """``ts`` as a marker returns them: one tensor alone, else the tuple."""
    return ts[0] if len(ts) == 1 else tuple(ts)


class _NullBackwardRange:
    """:func:`backward_range` while device ranges are off: both markers
    return their tensors as given."""

    __slots__ = ()

    def close_at(self, *ts):
        """``ts`` unchanged."""
        return _as_given(ts)

    open_at = close_at


_NULL_BACKWARD = _NullBackwardRange()


class BackwardRange:
    """A profiler range ``name`` around one region's backward.

    ``close_at(*inputs)`` is an identity on the region's inputs whose
    backward closes the range, ``open_at(*outputs)`` one on its outputs
    whose backward opens it: autograd runs the region's backward between
    the two (a checkpoint's recompute inside it). Where no input needs a
    gradient the close would never run, and neither marker is placed."""

    __slots__ = ("name", "rf", "live")

    def __init__(self, name: str):
        self.name, self.rf, self.live = name, None, False

    def close_at(self, *ts):
        """``ts`` through the marker whose backward closes the range."""
        self.live = any(t.requires_grad for t in ts)
        return _mark(self, False, ts)

    def open_at(self, *ts):
        """``ts`` through the marker whose backward opens the range."""
        return _mark(self, True, ts) if self.live else _as_given(ts)

    def open(self):
        """Open the range (the outputs' marker, in the backward)."""
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        _OPEN[id(self)] = self

    def close(self):
        """Close it (the inputs' marker, in the backward)."""
        if _OPEN.pop(id(self), None) is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def backward_range(name: str):
    """A :class:`BackwardRange` named ``name`` under :func:`device_ranges`,
    else a shared one whose markers change nothing."""
    return BackwardRange(name) if _RANGES else _NULL_BACKWARD


_MARKER = None


def _mark(rng: BackwardRange, opens: bool, ts):
    global _MARKER
    if _MARKER is None:
        import torch

        class _Marker(torch.autograd.Function):
            """Identity on tensors whose backward opens or closes a
            :class:`BackwardRange`."""

            @staticmethod
            def forward(ctx, rng, opens, *ts):
                ctx.rng, ctx.opens = rng, opens
                ctx.set_materialize_grads(False)
                return tuple(t.view_as(t) for t in ts)

            @staticmethod
            def backward(ctx, *gs):
                if ctx.opens:
                    ctx.rng.open()
                else:
                    ctx.rng.close()
                return (None, None) + gs
        _MARKER = _Marker
    # only the tensors that carry a gradient go through the marker
    idx = [i for i, t in enumerate(ts) if t.requires_grad]
    out = list(ts)
    if idx:
        for i, t in zip(idx, _MARKER.apply(rng, opens,
                                           *(ts[i] for i in idx))):
            out[i] = t
    return _as_given(out)


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

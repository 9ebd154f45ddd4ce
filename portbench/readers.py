"""What the metric readers in ``metrics/`` share: the window's rate, tail
and model FLOP share (host clock), the traced stretch's idle share, a
kernel's share of its roofline (device trace), and the program's spans and
counters over the stretch's span calls (``trace.span_split``)."""
from __future__ import annotations

import statistics
import sys

from . import counts, trace


def tokens_per_s(run):
    """Every token the window's steps or requests completed over the
    window's seconds, from its start to the last completion."""
    if not run.records:
        return None
    return sum(sum(r["seqs"]) for r in run.records) / run.window_s


def p90_ms(run):
    """The 90th percentile of the window's step or request times, each
    from its call to its synchronised result."""
    times = [(r["t1"] - r["t0"]) * 1e3 for r in run.records]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]


def mfu(run):
    """The model FLOPs that the window's steps or requests needed
    (``counts.step_flops``) over the window's seconds, as a share of the
    card's bf16 peak."""
    if not run.records:
        return None
    train = run.mix["driver"] == "train"
    window = run.config.get("sliding_window") or 0
    flops = sum(counts.step_flops(run.config, r["seqs"], train, window)
                for r in run.records)
    return 100.0 * flops / run.window_s / run.peaks["bf16"]


def idle_share(run):
    """The share of the traced stretch's wall in which no operation ran on
    the device."""
    if not run.stretch or run.stretch["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.stretch["busy_s"] / run.stretch["window_s"])


def roofline_share(run, main, every, bounds_of, exclude=()):
    """A kernel's share of its roofline over the traced stretch: the sum of
    each launch's bound, from shapes worked out from the configuration and
    each call's sequence lengths, over the device time of the kernel's
    launches, attributed by name. ``main``: names of the kernel. A call (a
    step or a request) runs the mix's ``microbatches`` (1 where it names
    none), each over an equal share of the call's sequences, and
    ``bounds_of(seqs)`` gives the launches of one forward (or backward) of
    such a share as ``[(launches, one launch's bound)]``, a pair for each
    shape. ``every``: the names whose device time counts (``main`` and its
    helpers). None where the stretch has none of them, or where a call
    launched another count than its inputs need (the accounting would not
    hold)."""
    st = run.stretch
    if not st:
        return None
    seconds = trace.class_time(st, every)
    if seconds <= 0:
        return None
    micro = run.mix.get("microbatches", 1)
    total = 0.0
    for call in st["calls"]:
        share = call["seqs"][:len(call["seqs"]) // micro]
        groups = bounds_of(share)
        want = sum(n for n, _ in groups) * micro
        got = trace.class_calls(call, main, exclude)
        if got != want:
            print(f"roofline {main}: {got} launches in a call that needs "
                  f"{want}; not read", file=sys.stderr)
            return None
        total += sum(n * micro * b for n, b in groups)
    return 100.0 * total / seconds


def spans(run):
    """The traced stretch's span calls' readings, or None (no stretch, or
    a program without device ranges)."""
    return run.stretch.get("spans") if run.stretch else None


def span_ms(run, where):
    """The device ms of the span calls' kernels that ``where(names)``
    takes, ``names`` the set of the program's spans a kernel was launched
    inside (``trace.feeds(reading)`` for a reading of
    ``trace.STEP_SPANS``), a span call's mean (a step's, or a request's);
    None where it takes no kernel."""
    sp = spans(run)
    got = [ms for names, ms in sp["by_spans"] if where(set(names))] \
        if sp else []
    return sum(got) / sp["calls"] if got else None


def program_idle_share(run):
    """The share of the span calls' wall in which the host was inside a
    top span (``rt.train.step``, ``rt.serve.prefill``) and not in the
    profiler's own events, and no operation ran on the device."""
    sp = spans(run)
    if not sp or not set(trace.TOP_SPANS) & set(sp["spans"]) \
            or sp["wall_ms"] <= 0:
        return None
    return 100.0 * sp["program_idle_ms"] / sp["wall_ms"]


def counter_share(run, part, whole):
    """Counter ``part``'s increase over counter ``whole``'s across the span
    calls, as a share; None where ``whole`` did not grow."""
    sp = spans(run)
    got = sp["counters"] if sp else {}
    if not got.get(whole):
        return None
    return 100.0 * got.get(part, 0) / got[whole]

"""What the metric readers in ``metrics/`` share: the window's rate, tail
and model FLOP share (host clock), the traced stretch's idle share, and a
kernel's share of its roofline (device trace)."""
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


def roofline_share(run, main, every, launches, bound_of, exclude=()):
    """A kernel's share of its roofline over the traced stretch: the sum of
    each launch's bound, from shapes worked out from the configuration and
    each call's sequence lengths, over the device time of the kernel's
    launches, attributed by name. ``main``: names of the kernel, launched
    ``launches`` times a forward (or backward) of one microbatch; a call
    (a step or a request) runs the mix's ``microbatches`` (1 where it
    names none), each over an equal share of the call's sequences, and
    ``bound_of(seqs)`` is one launch's bound over such a share. ``every``:
    the names whose device time counts (``main`` and its helpers). None
    where the stretch has none of them, or where a call launched another
    count than its inputs need (the accounting would not hold)."""
    st = run.stretch
    if not st:
        return None
    seconds = trace.class_time(st, every)
    if seconds <= 0:
        return None
    micro = run.mix.get("microbatches", 1)
    total = 0.0
    for call in st["calls"]:
        want = launches * micro
        got = trace.class_calls(call, main, exclude)
        if got != want:
            print(f"roofline {main}: {got} launches in a call that needs "
                  f"{want}; not read", file=sys.stderr)
            return None
        share = call["seqs"][:len(call["seqs"]) // micro]
        total += want * bound_of(share)
    return 100.0 * total / seconds

"""The traced stretch: one ``torch.profiler`` session over a few calls of
the timed entry, reduced in memory to what the per-layer readers need.

Each call runs inside a range of the benchmark's own
(``portbench.call``) that ends after a synchronise, so every device kernel
of a call runs before the next call begins. In one process
the profiler has lost kernels after its first session, so a run opens one
session, and the stretch is refused (``ValueError``) unless the device
kernels equal the launch calls that the host made.

Where the program has ``repro_torch.obs.trace.device_ranges``, the same
session then runs as many calls again (``portbench.span_call``) with the
program's spans turned on, and reduces them by span (``span_split``,
after ``chip_smoke.span_split``: the same attribution and idle) and by the
``REGISTRY`` counters' differences. Those calls come after the first ones and feed only
``stretch["spans"]``: every other reading (``calls``, ``busy_s``,
``window_s``, ``breakdown``) is of the first calls alone, as without them.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

RANGE = "portbench.call"
SPAN_RANGE = "portbench.span_call"
TOP = 10

# The program's spans by the reading each feeds: a kernel feeds the
# readings of every span whose host interval holds its launch call; the
# MoE block's backward less its expert products' is dispatch too
# (span_readings)
STEP_SPANS = {"chunked_ce": ("rt.train.ce", "rt.train.ce.bwd"),
              "adamw": ("rt.adamw.update",),
              "accumulate": ("rt.train.accumulate",),
              "moe_dispatch": ("rt.moe.route", "rt.moe.pack",
                               "rt.moe.combine"),
              "moe_experts": ("rt.moe.experts", "rt.moe.experts.bwd"),
              "train_step": ("rt.train.step",),
              "prefill": ("rt.serve.prefill",)}
MOE_BWD, MOE_EXPERTS_BWD = "rt.moe.bwd", "rt.moe.experts.bwd"
TOP_SPANS = STEP_SPANS["train_step"] + STEP_SPANS["prefill"]
SPAN_PREFIX = "rt."
# the profiler's own host events (its buffer requests), whose idle is not
# the program's
PROFILER_EVENTS = ("Activity Buffer Request", "Activity_Buffer_Request")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _subtract(xs, ys):
    """The merged intervals ``xs`` less the merged intervals ``ys``."""
    out = []
    for a, b in xs:
        cur = a
        for c, d in ys:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append([cur, c])
            cur = max(cur, d)
        if cur < b:
            out.append([cur, b])
    return out


def _inside(intervals, t):
    """Whether ``t`` lies in one of the merged ``intervals``."""
    j = bisect.bisect_right(intervals, [t, float("inf")]) - 1
    return j >= 0 and t < intervals[j][1]


def program_spans():
    """``(device_ranges, REGISTRY)`` of the program, or None where it has
    no device ranges (then no span call runs)."""
    try:
        from repro_torch.obs.metrics import REGISTRY
        from repro_torch.obs.trace import device_ranges
    except ImportError:
        return None
    return device_ranges, REGISTRY


def counters(registry) -> dict:
    """The registry's counters now (a device tensor's read once)."""
    return dict(registry.snapshot()["counters"])


def span_readings(names):
    """The readings of ``STEP_SPANS`` that a kernel launched inside the
    spans ``names`` feeds."""
    out = {r for r, spans in STEP_SPANS.items() if names & set(spans)}
    if MOE_BWD in names and MOE_EXPERTS_BWD not in names:
        out.add("moe_dispatch")
    return out


def feeds(reading):
    """Whether a kernel launched inside the spans ``names`` feeds
    ``reading`` of ``STEP_SPANS``: a test on ``names`` for
    ``readers.span_ms``."""
    return lambda names: reading in span_readings(names)


def span_split(events):
    """The program's spans over a profile's events (``prof.events()``, or
    objects with their ``name``, ``id``, ``device_type`` and
    ``time_range``): each device kernel's ms by the set of spans whose host
    interval holds its launch call (``by_spans``: ``[names, ms]``; the
    runtime event ``cu*`` with the kernel's correlation id: the program
    runs one host thread at a time, the autograd engine's while the caller
    waits, so a span's host interval holds the launches of its work); the
    spans seen; the kernels no launch call names; and the idle the program
    causes: time inside the top spans (``rt.train.step``,
    ``rt.serve.prefill``) in which no device op ran and the host was not
    in one of the profiler's own events. ``chip_smoke.span_split`` gives
    the same by the readings of ``STEP_SPANS``."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not e.name.startswith(SPAN_PREFIX)
           and e.name not in (RANGE, SPAN_RANGE)]
    launch = {e.id: e for e in cpu if e.name.startswith("cu")}
    host = defaultdict(list)
    for e in cpu:
        if e.name.startswith(SPAN_PREFIX):
            host[e.name].append((e.time_range.start, e.time_range.end))
    host = {k: _union(v) for k, v in host.items()}
    by_spans = defaultdict(float)
    unlinked = 0
    for k in dev:
        op = launch.get(k.id)
        if op is None:
            unlinked += 1
            continue
        names = {n for n, iv in host.items()
                 if _inside(iv, op.time_range.start)}
        k_ms = (k.time_range.end - k.time_range.start) / 1e3
        by_spans[tuple(sorted(names))] += k_ms
    tops = _union(iv for n in TOP_SPANS for iv in host.get(n, ()))
    busy = _union((e.time_range.start, e.time_range.end) for e in dev)
    own = _union((e.time_range.start, e.time_range.end) for e in cpu
                 if e.name in PROFILER_EVENTS)
    idle = _subtract(_subtract(tops, busy), own)
    return dict(by_spans=[[list(k), v] for k, v in by_spans.items()],
                spans=sorted(host), unlinked_kernels=unlinked,
                program_idle_ms=sum(b - a for a, b in idle) / 1e3,
                top_span_ms=sum(b - a for a, b in tops) / 1e3)


def _call_starts(events, cpu_type, named):
    """The starts of the calls, for each ``(name, n)`` of ``named`` in
    turn: on the device's own timeline (the ranges' annotations) where the
    profile has every one of them, else on the host's; and whether on the
    device."""
    def starts(on_dev, name):
        return sorted(e.time_range.start for e in events if e.name == name
                      and (e.device_type != cpu_type) == on_dev)
    dev = [starts(True, name) for name, _ in named]
    if all(len(d) == n for d, (_, n) in zip(dev, named)):
        return [t for d in dev for t in d], True
    return [t for name, _ in named for t in starts(False, name)], False


def profile(run, fn, n_calls: int, seqs, seqs_of=None) -> dict:
    """Profile ``n_calls`` calls of ``fn(i)`` (or ``fn()``), after one more
    call that opens the session (the profiler's own start-up lands in it,
    and it is left out); ``seqs`` are the sequence lengths each call runs,
    or ``seqs_of(i)`` gives them. Where the program has device ranges, the
    same ``n_calls`` calls run again under them, in the same session.
    Returns ``{"calls": [{"seqs", "kernels": [(name, s)]}], "busy_s",
    "window_s", "breakdown", "spans"}``; ``spans`` (None without device
    ranges) holds ``span_split``'s readings of the span calls, their
    number (``calls``) and wall (``wall_ms``), and the counters'
    differences over them (``counters``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_session, \
        record_function
    program = program_spans()
    n_span = n_calls if program else 0

    def call(i, name):
        with record_function(name):
            fn(max(i, 0)) if seqs_of else fn()
            torch.cuda.synchronize()
    run.sync()
    before = counters(program[1]) if program else None
    with prof_session(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        for i in range(-1, n_calls):
            call(i, RANGE)
        if program:
            with program[0]():
                for i in range(n_span):
                    call(i, SPAN_RANGE)
    after = counters(program[1]) if program else None
    events = prof.events()
    CPU = DeviceType.CPU
    cpu = [e for e in events if e.device_type == CPU]
    dev = [e for e in events if e.device_type != CPU
           and e.name not in (RANGE, SPAN_RANGE)
           and not e.name.startswith(SPAN_PREFIX)]
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in cpu if e.name == RANGE)
    if len(ranges) != n_calls + 1:
        raise ValueError(f"{len(ranges)} call ranges for {n_calls + 1} calls")
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    launches = sum(1 for e in cpu if "LaunchKernel" in e.name)
    if len(kernels) != launches:
        raise ValueError(f"the profile holds {len(kernels)} device kernels "
                         f"for {launches} launch calls: events were dropped")
    # each device op goes to the last call that began before it: calls run
    # one after another, each ending in a synchronise. The calls' spans on
    # the device's own timeline (the ranges' annotations) are used where
    # the profile has them all, since the device's clock and the host's
    # may differ by more than a call's first kernels take. The span calls
    # come last, and what they run is no first call's
    starts, on_dev = _call_starts(events, CPU, [(RANGE, n_calls + 1),
                                                (SPAN_RANGE, n_span)])
    calls = [{"seqs": seqs_of(i) if seqs_of else list(seqs), "kernels": []}
             for i in range(n_calls)]
    timed = []
    for e in dev:
        i = max(bisect.bisect_right(starts, e.time_range.start) - 1, 0)
        if 0 < i <= n_calls:
            calls[i - 1]["kernels"].append(
                (e.name, (e.time_range.end - e.time_range.start) / 1e6))
            timed.append(e)
    t0, t1 = ranges[1][0], ranges[-1][1]
    busy = _union((e.time_range.start, e.time_range.end) for e in timed)
    by_name = defaultdict(float)
    for e in timed:
        by_name[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e6
    gaps = [(a, b) for (_, a), (b, _) in zip([(t0, t0)] + busy,
                                             busy + [(t1, t1)]) if b > a]
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in cpu if e.name not in (RANGE, SPAN_RANGE)]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
        idle.append([name[:120], (b - a) / 1e6])
    spans = None
    if program:
        walls = sorted((e.time_range.start, e.time_range.end)
                       for e in cpu if e.name == SPAN_RANGE)
        spans = dict(span_split(events), calls=n_span,
                     wall_ms=(walls[-1][1] - walls[0][0]) / 1e3,
                     counters={k: v - before.get(k, 0)
                               for k, v in after.items()})
    return {
        "calls": calls,
        "attributed_by": "device spans" if on_dev else "host ranges",
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "breakdown": {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                           key=lambda kv: -kv[1])[:TOP],
                      "idle_gaps": idle},
        "spans": spans,
    }


def class_time(stretch: dict, names) -> float:
    """Device seconds of the stretch's kernels whose name holds one of
    ``names``."""
    return sum(s for call in stretch["calls"] for k, s in call["kernels"]
               if any(n in k for n in names))


def class_calls(call: dict, names, exclude=()) -> int:
    """Kernels of one call whose name holds one of ``names`` and none of
    ``exclude``."""
    return sum(1 for k, _ in call["kernels"]
               if any(n in k for n in names) and not any(x in k for x in exclude))

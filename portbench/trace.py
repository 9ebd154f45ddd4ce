"""The traced stretch: one ``torch.profiler`` session over a few calls of
the timed entry, reduced in memory to what the per-layer readers need.

Each call runs inside a range of the benchmark's own
(``portbench.call``) that ends after a synchronise, so every device kernel
of a call runs before the next call begins. In one process
the profiler has lost kernels after its first session, so a run opens one
session, and the stretch is refused (``ValueError``) unless the device
kernels equal the launch calls that the host made.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

RANGE = "portbench.call"
TOP = 10


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(run, fn, n_calls: int, seqs, seqs_of=None) -> dict:
    """Profile ``n_calls`` calls of ``fn(i)`` (or ``fn()``), after one more
    call that opens the session (the profiler's own start-up lands in it,
    and it is left out); ``seqs`` are the sequence lengths each call runs,
    or ``seqs_of(i)`` gives them. Returns ``{"calls": [{"seqs", "kernels":
    [(name, s)]}], "busy_s", "window_s", "breakdown"}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_session, \
        record_function
    run.sync()
    with prof_session(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        for i in range(-1, n_calls):
            with record_function(RANGE):
                fn(max(i, 0)) if seqs_of else fn()
                torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and e.name != RANGE]
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
    # the profile has them, since the device's clock and the host's may
    # differ by more than a call's first kernels take
    spans = sorted(e.time_range.start for e in events
                   if e.device_type != DeviceType.CPU and e.name == RANGE)
    starts = spans if len(spans) == n_calls + 1 else [a for a, _ in ranges]
    calls = [{"seqs": seqs_of(i) if seqs_of else list(seqs), "kernels": []}
             for i in range(n_calls)]
    timed = []
    for e in dev:
        i = max(bisect.bisect_right(starts, e.time_range.start) - 1, 0)
        if i > 0:
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
            for e in cpu if e.name != RANGE]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
        idle.append([name[:120], (b - a) / 1e6])
    return {
        "calls": calls,
        "attributed_by": "device spans" if starts is spans else "host ranges",
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "breakdown": {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                           key=lambda kv: -kv[1])[:TOP],
                      "idle_gaps": idle},
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

"""The traced stretch's reduction by the program's spans and counters, on
synthetic profiler events: which kernels a span's readings take, the MoE
backward less its experts' backward, a kernel that no launch call names,
the program's idle inside a top span, and the counters' difference over
the span calls, which leave every other reading of the stretch as it was
without them."""
import contextlib
import itertools
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import readers, trace

_ids = itertools.count(1)


def ev(name, start, end, dev=False, id=0):
    return SimpleNamespace(name=name, id=id,
                           device_type=DeviceType.CUDA if dev
                           else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def kernel(name, launch_at, start, end):
    """A launch call at ``launch_at`` (host) and its kernel (device)."""
    i = next(_ids)
    return [ev("cudaLaunchKernel", launch_at, launch_at + 1, id=i),
            ev(name, start, end, dev=True, id=i)]


def split(events, calls=1):
    """A stretch whose span calls (``calls`` of them) made ``events``."""
    return {"spans": dict(trace.span_split(events), calls=calls)}


def read(stretch, reading):
    """A span call's ms of ``reading`` of ``trace.STEP_SPANS``."""
    return readers.span_ms(SimpleNamespace(stretch=stretch),
                           trace.feeds(reading))


def test_a_kernel_inside_nested_spans_feeds_each():
    events = [ev("rt.train.step", 0, 1000), ev("rt.train.ce", 100, 200),
              *kernel("ce_kernel", 150, 300, 340),
              *kernel("gemm", 500, 600, 700)]
    got = split(events, calls=1)
    assert got["spans"]["spans"] == ["rt.train.ce", "rt.train.step"]
    assert read(got, "chunked_ce") == pytest.approx(0.040)
    assert read(got, "train_step") == pytest.approx(0.140)
    assert read(got, "adamw") is None
    # by the set of spans each kernel was launched in, for any reading
    assert sorted(got["spans"]["by_spans"]) == [
        [["rt.train.ce", "rt.train.step"], pytest.approx(0.040)],
        [["rt.train.step"], pytest.approx(0.100)]]
    run = SimpleNamespace(stretch=split(events, calls=2))
    assert readers.span_ms(run, lambda names: "rt.train.ce" in names) \
        == pytest.approx(0.020)
    assert readers.span_ms(run, lambda names: "rt.mla" in names) is None


def test_moe_backward_less_its_experts_is_dispatch():
    events = [ev("rt.moe.bwd", 0, 1000), ev("rt.moe.experts.bwd", 200, 400),
              *kernel("indexing_backward_kernel", 100, 1100, 1180),
              *kernel("bmm", 300, 1200, 1500),
              ev("rt.moe.route", 2000, 2100),
              *kernel("topk", 2050, 2200, 2210)]
    got = split(events)
    assert read(got, "moe_dispatch") == pytest.approx(0.080 + 0.010)
    assert read(got, "moe_experts") == pytest.approx(0.300)


def test_a_kernel_no_launch_call_names_feeds_nothing():
    events = [ev("rt.adamw.update", 0, 100),
              ev("adamw_update", 150, 250, dev=True, id=999999),
              *kernel("adamw_sumsq", 10, 120, 140)]
    got = split(events)
    assert got["spans"]["unlinked_kernels"] == 1
    assert read(got, "adamw") == pytest.approx(0.020)


def test_program_idle_inside_a_top_span():
    """Top span [0, 100] us; kernels busy [10, 30] and [50, 60]; the
    profiler's own buffer request [70, 80]: idle 10 + 20 + 10 + 20 us.
    Idle outside the top span is not the program's."""
    events = [ev("rt.serve.prefill", 0, 100),
              *kernel("a", 1, 10, 30), *kernel("b", 2, 50, 60),
              ev("Activity Buffer Request", 70, 80),
              ev("host_work", 150, 400)]
    got = trace.span_split(events)
    assert got["program_idle_ms"] == pytest.approx(0.060)
    assert got["top_span_ms"] == pytest.approx(0.100)


# -- the whole stretch, under a stand-in for the profiler ------------------

class Clock:
    def __init__(self):
        self.t, self.events, self.ranges_on = 0, [], False

    def tick(self, dt):
        self.t += dt
        return self.t


class Session:
    """Stands in for ``torch.profiler.profile``: its events are what the
    stand-ins below record while it is open."""

    def __init__(self, clock):
        self.clock = clock

    def __call__(self, activities=()):
        return self

    def __enter__(self):
        self.clock.events = []
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return list(self.clock.events)


class Registry:
    def __init__(self):
        self.values = {"moe.rows_kept": 5, "moe.slots": 10}

    def snapshot(self):
        return {"counters": dict(self.values)}


def stand_ins(monkeypatch, with_program):
    import torch
    clock, registry = Clock(), Registry()

    @contextlib.contextmanager
    def record_function(name):
        start = clock.tick(1)
        yield
        clock.events.append(ev(name, start, clock.tick(1)))

    @contextlib.contextmanager
    def device_ranges():
        clock.ranges_on = True
        yield
        clock.ranges_on = False

    monkeypatch.setattr(torch.profiler, "profile", Session(clock))
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "program_spans",
                        lambda: (device_ranges, registry)
                        if with_program else None)

    def step():
        """A step: a kernel of 30 us, then 20 us of the host's own work
        inside its top span, then AdamW's kernel of 10 us."""
        top = clock.tick(1)
        clock.events += kernel("gemm", clock.tick(1), clock.tick(1),
                               clock.tick(30))
        clock.tick(20)
        a0 = clock.tick(1)
        clock.events += kernel("adamw_update", clock.tick(1), clock.tick(1),
                               clock.tick(10))
        end = clock.tick(1)
        if clock.ranges_on:
            clock.events += [ev("rt.train.step", top, end),
                             ev("rt.adamw.update", a0, end)]
            registry.values["moe.rows_kept"] += 3
            registry.values["moe.slots"] += 4
    return step


def stretch(monkeypatch, with_program):
    step = stand_ins(monkeypatch, with_program)
    run = SimpleNamespace(sync=lambda: None)
    return trace.profile(run, step, 2, [4096] * 8)


def test_span_calls_leave_the_first_calls_readings_as_they_were(monkeypatch):
    plain = stretch(monkeypatch, False)
    spanned = stretch(monkeypatch, True)
    assert plain["spans"] is None and spanned["spans"] is not None
    for key in ("calls", "busy_s", "window_s", "breakdown", "attributed_by"):
        assert spanned[key] == plain[key], key
    assert [len(c["kernels"]) for c in spanned["calls"]] == [2, 2]


def test_span_calls_read_spans_and_counters(monkeypatch):
    st = stretch(monkeypatch, True)
    sp = st["spans"]
    assert sp["calls"] == 2
    # counters: the span calls' increments only (2 calls of +3 / +4)
    assert sp["counters"] == {"moe.rows_kept": 6, "moe.slots": 8}
    run = SimpleNamespace(stretch=st)
    assert readers.span_ms(run, trace.feeds("adamw")) == pytest.approx(0.010)
    assert readers.span_ms(run, trace.feeds("accumulate")) is None  # no span
    assert readers.counter_share(run, "moe.rows_kept", "moe.slots") \
        == pytest.approx(75.0)
    # a step's idle inside its top span: 2 us before the first kernel,
    # 23 between the two (its 20 us of host work and AdamW's launch), 1
    # after the last
    assert sp["program_idle_ms"] == pytest.approx(2 * 0.026)
    assert readers.program_idle_share(run) == pytest.approx(
        100 * 0.052 / sp["wall_ms"])


def test_without_program_spans_the_span_readers_read_nothing(monkeypatch):
    run = SimpleNamespace(stretch=stretch(monkeypatch, False))
    assert readers.span_ms(run, trace.feeds("adamw")) is None
    assert readers.program_idle_share(run) is None
    assert readers.counter_share(run, "moe.rows_kept", "moe.slots") is None

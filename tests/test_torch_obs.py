"""The JAX package's observability checks (``tests/test_obs.py``) held
against the port's ``repro_torch.obs``.

Span nesting and the no-op module API when tracing is off; a Chrome trace
of a traced ``verify`` with the engine's spans, loading through both
export formats; certificates identical with tracing on or off; per-lemma
stats identical in process and on two spawned workers; the inspection
renderer and the metrics registry, each fed the same events or samples as
the JAX package's and giving the same output; and the CLI's ``--trace`` /
``--metrics`` leaving the envelope and certificate as they were. The
workers' distinct pids are held in ``test_torch_suite.py``.

The port's own: the training and serving path's spans and MoE counters
under ``obs.trace.device_ranges`` (every span on a CPU profile, each
backward range closed, the counters against ``moe.route``), and with the
switch off no autograd node, no profiler op and no change to a step's
loss or gradients.
"""
import collections
import contextlib
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro import obs as jobs
from repro.obs import trace as jtrace
from repro.obs.inspect import lemma_totals as jlemma_totals
from repro.obs.inspect import obligation_rows as jobligation_rows
from repro.obs.inspect import render as jrender
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.metrics import render as jrender_metrics

from repro_torch import obs
from repro_torch.api import Suite, verify
from repro_torch.launch.verify import main as verify_main
from repro_torch.models import moe, registry
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.inspect import (lemma_totals, obligation_rows, render,
                                     report)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.metrics import render as render_metrics
from repro_torch.train import (TrainConfig, init_state, loop, make_grad_fn,
                               make_loss_fn, make_train_step)
from repro_torch.train.serve import prefill_logits
from torch_parity import one_thread_module  # noqa: F401 (one thread)

CPU = {"device": "cpu"}



@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """A test that fails mid-span must not leave its tracer installed."""
    yield
    obs_trace.install(None)
    jtrace.install(None)


def _spans(events):
    return [e for e in events if e.get("ph") == "X"]


# ---------------------------------------------------------------------------
# spans: nesting, export formats
# ---------------------------------------------------------------------------

def _nested(o, trace):
    tracer = trace.start("t")
    with o.span("outer", cat="engine", tag=1):
        with o.span("inner_a"):
            time.sleep(0.001)
        with o.span("inner_b"):
            time.sleep(0.001)
    trace.stop()
    return tracer


def test_span_nesting_well_formed():
    tracer = _nested(obs, obs_trace)
    spans = {e["name"]: e for e in _spans(tracer.events)}
    outer, a, b = spans["outer"], spans["inner_a"], spans["inner_b"]
    assert outer["args"]["depth"] == 0 and outer["args"]["tag"] == 1
    assert a["args"]["depth"] == b["args"]["depth"] == 1
    assert outer["pid"] == a["pid"] == b["pid"] == tracer.pid
    for inner in (a, b):
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert a["ts"] + a["dur"] <= b["ts"]
    # the same events as the JAX tracer's, times and pids aside
    jspans = _spans(_nested(jobs, jtrace).events)

    def shape(es):
        return [(e["name"], e["cat"], e["args"]) for e in es]
    assert shape(_spans(tracer.events)) == shape(jspans)


def test_module_level_api_is_noop_when_off():
    assert obs_trace.current() is None
    with obs.span("nothing"):
        obs.event("nothing.event")
        obs.counter("nothing.counter", n=1)
        obs.complete("nothing.span", 1.0, 2.0)
    assert obs_trace.current() is None


def test_chrome_trace_loads_and_has_engine_spans(tmp_path):
    tracer = obs_trace.start("main")
    rep = verify("tp_layer", **CPU)
    obs_trace.stop()
    assert rep.ok
    path = tmp_path / "trace.json"
    tracer.write_chrome(str(path))
    obj = json.loads(path.read_text())
    assert obj["displayTimeUnit"] == "ms"
    evs = obj["traceEvents"]
    assert evs and evs[0]["ph"] == "M"
    for e in evs:
        assert {"name", "ph", "ts", "pid"} <= set(e)
    names = {e["name"] for e in evs}
    assert {"capture", "infer", "saturate", "extract",
            "saturate.batch"} <= names
    assert any(n.startswith("op:") for n in names)
    jl = tmp_path / "trace.jsonl"
    tracer.write_jsonl(str(jl))
    assert len(obs_trace.load_events(str(path))) == len(evs)
    assert len(obs_trace.load_events(str(jl))) == \
        len([e for e in evs if e["ph"] != "M"])


# ---------------------------------------------------------------------------
# behaviour-neutrality
# ---------------------------------------------------------------------------

def test_certificate_byte_identical_tracing_on_off():
    off = verify("tp_layer", **CPU)
    tracer = obs_trace.start("main")
    on = verify("tp_layer", **CPU)
    obs_trace.stop()
    assert tracer.events
    assert off.ok and on.ok
    assert json.dumps(off.r_o, sort_keys=True) == \
        json.dumps(on.r_o, sort_keys=True)
    for k in ("lemmas", "lemma_fires", "gs_ops", "gd_ops", "egraph_nodes"):
        assert off.stats[k] == on.stats[k], k


def test_lemma_stats_deterministic_across_worker_counts():
    with Suite(cases=["tp_layer"], degrees=(2,)) as s:
        seq = s.run(workers=0, **CPU)
        par = s.run(workers=2, timeout_s=120.0, **CPU)
    a = seq.reports[0].stats["lemmas"]
    b = par.reports[0].stats["lemmas"]
    assert a and a == b
    for row in a.values():
        assert set(row) == {"calls", "hits", "fires"}
        assert row["hits"] <= row["calls"]
    assert par.summary()["runtime"]["tasks"] == 1
    assert "runtime" not in json.dumps(par.stable_summary())


# ---------------------------------------------------------------------------
# inspection: renderer + metrics registry
# ---------------------------------------------------------------------------

def _inspected(trace):
    tracer = trace.Tracer("main")
    tracer.event("saturate.batch", cat="engine",
                 fires={"concat_merge": 5, "slice_cover": 1},
                 ms={"concat_merge": 2.0, "slice_cover": 1.0})
    tracer.complete("queue", 10.0, 10.5, key="ob1")
    tracer.complete("run", 10.5, 11.0, key="ob1", status="ok")
    return tracer


def test_inspect_render_names_top_lemma(tmp_path, capsys):
    tracer = _inspected(obs_trace)
    totals = lemma_totals(tracer.events)
    assert totals["concat_merge"] == {"fires": 5, "ms": 2.0}
    rows = obligation_rows(tracer.events)
    assert rows[0]["key"] == "ob1"
    assert rows[0]["queue_ms"] == pytest.approx(500.0)
    assert rows[0]["run_ms"] == pytest.approx(500.0)
    out = render(tracer.events)
    assert "ob1" in out and "queue" in out
    assert out.endswith("top lemma: concat_merge")
    jevents = _inspected(jtrace).events
    assert totals == jlemma_totals(jevents)
    assert rows == jobligation_rows(jevents)
    assert out.splitlines()[-1] == jrender(jevents).splitlines()[-1]
    p = tmp_path / "t.json"
    tracer.write_chrome(str(p))
    assert report(str(p)) == 0
    assert "top lemma: concat_merge" in capsys.readouterr().out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report(str(empty)) == 1


def _metrics(Registry):
    reg = Registry()
    reg.counter("cache.hits").inc()
    reg.counter("cache.hits").inc(2)
    h = reg.histogram("pool.queue_s")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    return reg


def test_metrics_registry_and_render():
    reg = _metrics(MetricsRegistry)
    snap = reg.snapshot()
    assert snap["counters"] == {"cache.hits": 3}
    hs = snap["histograms"]["pool.queue_s"]
    assert hs["count"] == 4 and hs["sum"] == 10.0
    assert hs["min"] == 1.0 and hs["max"] == 4.0
    text = render_metrics(reg)
    assert text.startswith("-- metrics --")
    assert "cache.hits" in text and "pool.queue_s" in text
    jreg = _metrics(JMetricsRegistry)
    assert snap == jreg.snapshot()
    assert text == jrender_metrics(jreg)
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "histograms": {}}
    assert "(no metrics recorded)" in render_metrics(reg)


def test_histogram_reservoir_is_deterministic():
    """Two port registries, and the JAX package's, fed one stream that
    wraps the reservoir twice keep the same samples and snapshot."""
    regs = [MetricsRegistry(), MetricsRegistry(), JMetricsRegistry()]
    for reg in regs:
        h = reg.histogram("x")
        for i in range(3 * h.SAMPLE + 7):
            h.observe(i % 97)
    a, b, j = regs
    assert a.snapshot() == b.snapshot() == j.snapshot()
    assert a.histogram("x")._sample == j.histogram("x")._sample
    assert a.histogram("x").SAMPLE == j.histogram("x").SAMPLE


# ---------------------------------------------------------------------------
# CLI: --trace / --metrics
# ---------------------------------------------------------------------------

def _case_envelope(capsys, argv):
    try:
        verify_main(argv + ["--device", "cpu"])
    except SystemExit as e:
        assert e.code in (None, 0)
    return json.loads(capsys.readouterr().out)


def _stable_report(env):
    rep = json.loads(json.dumps(env["report"]))
    rep.pop("wall_s", None)
    rep.pop("runtime", None)
    stats = rep.get("stats") or {}
    stats.pop("time_s", None)
    stats.pop("phase_s", None)
    return json.dumps(rep, sort_keys=True)


def test_cli_trace_does_not_change_envelope_or_certificate(tmp_path, capsys):
    plain = _case_envelope(capsys, ["--case", "tp_layer", "--json"])
    traced = _case_envelope(
        capsys, ["--case", "tp_layer", "--json",
                 "--trace", str(tmp_path / "t.json")])
    assert set(plain) == set(traced) == \
        {"schema_version", "kind", "timing", "report"}
    assert _stable_report(plain) == _stable_report(traced)


def test_cli_trace_and_metrics_flags(tmp_path, capsys):
    trace_path = tmp_path / "trace.json"
    verify_main(["--case", "tp_layer", "--json", "--device", "cpu",
                 "--trace", str(trace_path), "--metrics"])
    cap = capsys.readouterr()
    env = json.loads(cap.out)
    assert set(env) == {"schema_version", "kind", "timing", "report",
                        "metrics"}
    assert env["metrics"]["counters"].get("engine.runs", 0) >= 1
    assert "-- metrics --" in cap.err and "[obs] wrote" in cap.err
    assert trace_path.exists()
    assert (tmp_path / "trace.json.jsonl").exists()
    events = obs_trace.load_events(str(trace_path))
    assert any(e.get("name") == "infer" for e in events)
    assert "top lemma:" in render(events)
    assert obs_trace.current() is None


# ---------------------------------------------------------------------------
# device ranges: the training and serving path's spans and counters
# ---------------------------------------------------------------------------

TRAIN_SPANS = ("rt.train.step", "rt.train.accumulate", "rt.adamw.update",
               "rt.train.ce", "rt.train.ce.bwd", "rt.moe.route",
               "rt.moe.pack", "rt.moe.experts", "rt.moe.combine",
               "rt.moe.bwd", "rt.moe.experts.bwd")
MOE_COUNTERS = ("moe.rows_routed", "moe.rows_kept", "moe.slots")
MICRO = 2


def _tiny_mixtral():
    cfg = registry.load_config("mixtral-8x7b").reduced()
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (2 * MICRO, 32), generator=g)
             for k in ("tokens", "labels")}
    return cfg, batch


class _NoMarkers:
    def close_at(self, *ts):
        return ts[0] if len(ts) == 1 else ts

    open_at = close_at


def _no_spans(monkeypatch):
    """The program as if it had no spans: ``span`` a null context and
    ``backward_range``'s markers bare pass-throughs."""
    monkeypatch.setattr(obs_trace, "span",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(obs_trace, "backward_range", lambda name: _NoMarkers())


def _graph_nodes(loss):
    seen, todo = {}, [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen[id(fn)] = fn.name()
        todo.extend(f for f, _ in fn.next_functions)
    return collections.Counter(seen.values())


def _step_readings(cfg, batch):
    """A step's loss, gradients and updated parameters, the profiler's ops
    of one step, and the loss's autograd nodes."""
    tcfg = TrainConfig(microbatches=MICRO)
    model, opt = init_state(cfg, 0, "cpu")
    grads, _ = make_grad_fn(cfg, tcfg)(model, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, opt, m = make_train_step(cfg, tcfg)(model, opt, batch)
    loss, _ = make_loss_fn(cfg, tcfg)(model, batch)
    return dict(loss=m["loss"], grads=grads,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                ops=collections.Counter(e.name for e in prof.events()),
                nodes=_graph_nodes(loss))


def test_spans_off_add_no_node_op_or_bit(monkeypatch):
    """With the switch off, a tiny mixtral step (2 microbatches: the
    accumulation, chunked CE, MoE, AdamW) gives the same loss, gradients
    and parameters, bit for bit, the same profiler ops and the same
    autograd nodes as the program with no spans at all; with it on the
    markers are there (so the count sees them) and the loss is unchanged."""
    cfg, batch = _tiny_mixtral()
    got = _step_readings(cfg, batch)
    with obs_trace.device_ranges():
        on = _step_readings(cfg, batch)
    with monkeypatch.context() as mp:
        _no_spans(mp)
        bare = _step_readings(cfg, batch)
    assert torch.equal(got["loss"], bare["loss"])
    assert torch.equal(on["loss"], bare["loss"])
    for part in ("grads", "params"):
        assert got[part].keys() == bare[part].keys()
        for n in bare[part]:
            assert torch.equal(got[part][n], bare[part][n]), (part, n)
    assert got["ops"] == bare["ops"]
    assert not any(n.startswith(obs_trace.PREFIX) for n in got["ops"])
    assert got["nodes"] == bare["nodes"]
    assert got["nodes"]["_MarkerBackward"] == 0
    # a CE piece's markers, and two a MoE block's in each of 2 layers
    assert on["nodes"]["_MarkerBackward"] == \
        2 * loop.CE_CHUNKS + 4 * cfg.n_layers


def _within(inner, outer):
    return outer.time_range.start <= inner.time_range.start \
        and inner.time_range.end <= outer.time_range.end


def test_device_ranges_record_every_span():
    """Under the switch and a CPU profile: every span of the training and
    serving path appears, as often as the step makes the work; every
    backward range that opens closes; the MoE's spans, backward ones
    included, nest in ``rt.train.step``."""
    cfg, batch = _tiny_mixtral()
    model, opt = init_state(cfg, 0, "cpu")
    step = make_train_step(cfg, TrainConfig(microbatches=MICRO))
    with obs_trace.device_ranges(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model, opt, _ = step(model, opt, batch)
        assert obs_trace.open_backward_ranges() == []
        prefill_logits(model, {"tokens": batch["tokens"][:1]})
    events = [e for e in prof.events() if e.name.startswith(obs_trace.PREFIX)]
    count = collections.Counter(e.name for e in events)
    blocks = MICRO * cfg.n_layers
    chunks = MICRO * loop.CE_CHUNKS
    assert count == {
        "rt.train.step": 1, "rt.adamw.update": 1,
        "rt.train.accumulate": MICRO, "rt.serve.prefill": 1,
        # each piece's forward and its recompute in the backward
        "rt.train.ce": 2 * chunks, "rt.train.ce.bwd": chunks,
        "rt.moe.route": blocks + cfg.n_layers,
        "rt.moe.pack": blocks + cfg.n_layers,
        "rt.moe.experts": blocks + cfg.n_layers,
        "rt.moe.combine": blocks + cfg.n_layers,
        "rt.moe.bwd": blocks, "rt.moe.experts.bwd": blocks}
    assert set(TRAIN_SPANS) | {"rt.serve.prefill"} == set(count)
    step_ev, = (e for e in events if e.name == "rt.train.step")
    prefill, = (e for e in events if e.name == "rt.serve.prefill")
    for e in events:
        if e.name.startswith("rt.moe."):
            assert _within(e, step_ev) or _within(e, prefill), e.name
    # the experts' backward inside the block's
    outer = [e for e in events if e.name == "rt.moe.bwd"]
    for e in (e for e in events if e.name == "rt.moe.experts.bwd"):
        assert any(_within(e, o) for o in outer)


def _counts():
    snap = REGISTRY.snapshot()["counters"]
    return {k: snap.get(k, 0) for k in MOE_COUNTERS}


@pytest.mark.parametrize("e0", [0, 2])
def test_moe_counters_match_the_routing(e0):
    """``moe.rows_routed``, ``moe.rows_kept`` and ``moe.slots`` add T*K,
    the routed rows that fit a local expert's capacity and El*C, counted
    here from ``moe.route`` directly (all the experts, or the last two
    as a mesh rank holds them); with the switch off they do not move."""
    cfg, _ = _tiny_mixtral()
    model, _ = init_state(cfg, 0, "cpu")
    p = model.blocks[0].moe
    # tokens alike, so that most of them pick the same experts and some of
    # those rows overflow their capacity
    g = torch.Generator().manual_seed(1)
    x = torch.randn(cfg.d_model, generator=g) \
        + 0.1 * torch.randn(2, 32, cfg.d_model, generator=g)
    experts = (p.wg[e0:], p.wu[e0:], p.wd[e0:])
    before = _counts()
    moe._moe_experts(cfg, x, p.router, *experts, e0)
    assert _counts() == before
    with torch.no_grad():
        with obs_trace.device_ranges():
            moe._moe_experts(cfg, x, p.router, *experts, e0)
        r = moe.route(p.router, cfg, x.reshape(-1, cfg.d_model))
    T, El = 2 * 32, cfg.n_experts - e0
    kept = int((r["keep"] & (r["se"] >= e0)).sum())
    assert 0 < kept < T * cfg.top_k
    after = _counts()
    assert {k: after[k] - before[k] for k in MOE_COUNTERS} == {
        "moe.rows_routed": T * cfg.top_k, "moe.rows_kept": kept,
        "moe.slots": El * r["C"]}


def test_device_ranges_restore_their_state():
    """The switch comes back as it was after the block, an error's
    included, and nests; off, a span is the shared null span; on, a span
    is a profiler range and, with a tracer installed, the tracer's span
    too."""
    assert not obs_trace.ranges_on()
    with pytest.raises(ValueError):
        with obs_trace.device_ranges():
            assert obs_trace.ranges_on()
            raise ValueError("inside")
    assert not obs_trace.ranges_on()
    assert obs_trace.span("rt.x") is obs_trace._NULL_SPAN
    with obs_trace.device_ranges():
        with obs_trace.device_ranges():
            assert obs_trace.ranges_on()
        assert obs_trace.ranges_on()
        tracer = obs_trace.start("t")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs_trace.span("rt.both"):
                pass
        obs_trace.stop()
    assert obs_trace.span("rt.x") is obs_trace._NULL_SPAN
    assert [e["name"] for e in _spans(tracer.events)] == ["rt.both"]
    assert [e.name for e in prof.events()] == ["rt.both"]


def test_backward_range_left_open_is_an_error():
    """A backward range whose close marker never runs (the gradient asked
    for skips the region's inputs) is closed and named by the switch's
    exit; one that closes leaves nothing open."""
    a = torch.ones(3, requires_grad=True)
    b = torch.full((3,), 2.0, requires_grad=True)
    with pytest.raises(RuntimeError, match="rt.t.bwd"):
        with obs_trace.device_ranges():
            rng = obs_trace.backward_range("rt.t.bwd")
            a_ = rng.close_at(a)
            out = rng.open_at(a_ * b)
            torch.autograd.grad(out.sum(), [b])
            assert obs_trace.open_backward_ranges() == ["rt.t.bwd"]
    assert obs_trace.open_backward_ranges() == []
    with obs_trace.device_ranges():
        rng = obs_trace.backward_range("rt.t.bwd")
        a_, b_ = rng.close_at(a, b)
        out = rng.open_at(a_ * b_)
        ga, gb = torch.autograd.grad(out.sum(), [a, b])
        assert obs_trace.open_backward_ranges() == []
    assert torch.equal(ga, b.detach()) and torch.equal(gb, a.detach())

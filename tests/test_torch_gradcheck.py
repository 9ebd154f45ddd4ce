"""repro_torch.gradcheck against repro.gradcheck: train-step checks.

Mirrors tests/test_gradcheck.py on the port (the registry, backward
capture, relation transposition, per-parameter certificates, bug
localization, the report and the CLI envelopes), on the CPU, and holds it
against the JAX package:

* backward form: the port's G_s of each parameter's gradient is the JAX
  capture's, def for def;
* engine parity: each obligation captured by the JAX package and carried
  across gives, through the port's engine, the JAX engine's verdict,
  ``pretty(R_o)``, localization, lemma fires and explanation steps;
  summed over a task they are ``BENCH_verify.json``'s;
* capture parity: the port's own ``check_train`` gives the JAX report's
  stable summary, certificates and fires, at every registered degree and
  for every bug;
* numeric parity: the same numpy inputs through each ``seq_fn``
  (``torch.func.grad`` against ``jax.grad``) and, per rank, the expanded
  G_d agree within 1e-5 of the output's scale (float32), and each clean
  certificate replays within rtol = atol = 2e-4.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import RefinementError as JRefinementError
from repro.core import capture as jcapture, check_refinement as jcheck
from repro.core import expand_spmd as jexpand, terms as JT
from repro.core.terms import eval_term as jeval
from repro.gradcheck import check_train as jcheck_train
from repro.gradcheck import get_train_strategy as jget_train_strategy
from repro.gradcheck.capture_grad import capture_grad_spmd as jcapture_gd

from repro_torch.api import check_train_task, list_train_tasks
from repro_torch.api.replay import max_rel_excess
from repro_torch.core import (RefinementError, check_refinement,
                              expand_spmd, spmd)
from repro_torch.core import terms as PT
from repro_torch.core.terms import eval_term
from repro_torch.gradcheck import (TrainReport, capture_backward,
                                   capture_grad, capture_grad_spmd,
                                   check_train, expected_grad_relation,
                                   get_train_strategy, grad_collective,
                                   list_train_bugs, list_train_strategies,
                                   register_train_strategy, replay_train)
from repro_torch.launch.verify import main as verify_main
from torch_parity import carried, close_to_scale, outcome, run, shard
from torch_parity import one_thread_module  # noqa: F401 (one thread)

P = spmd.PartitionSpec
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCH_verify.json")))
CPU = {"device": "cpu"}
ALL_TRAIN = list_train_strategies()
ALL_TRAIN_BUGS = sorted(list_train_bugs())
ALL_DEGREES = [(s, d) for s in ALL_TRAIN
               for d in get_train_strategy(s).degrees]


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_train_registry_covers_strategies_and_bugs():
    assert set(ALL_TRAIN) == {"dp", "dp_accum", "fsdp", "tp_dp_2d"}
    assert set(ALL_TRAIN_BUGS) == {"accum_no_rescale", "stale_grad_shard",
                                   "grad_psum_wrong_axis"}
    assert list_train_tasks() == tuple(f"train@{s}" for s in ALL_TRAIN)
    assert (4, 4) in get_train_strategy("tp_dp_2d").degrees
    for name in ALL_TRAIN:                    # the JAX registry, entry for entry
        mine, ref = get_train_strategy(name), jget_train_strategy(name)
        assert (mine.params, mine.degrees, dict(mine.bug_params),
                mine.description) == (ref.params, ref.degrees,
                                      dict(ref.bug_params), ref.description)
        assert [(b.name, b.expected, b.description) for b in mine.bugs] == \
            [(b.name, b.expected, b.description) for b in ref.bugs]


def test_train_registry_guards():
    with pytest.raises(KeyError, match="unknown train strategy"):
        get_train_strategy("no_such")
    with pytest.raises(ValueError, match="belongs to train strategy"):
        get_train_strategy("dp").build(bug="accum_no_rescale")
    with pytest.raises(ValueError, match="not hosted"):
        check_train("dp", bug="stale_grad_shard", **CPU)
    with pytest.raises(ValueError, match="single-axis"):
        check_train("dp", degree=(2, 2), **CPU)
    with pytest.raises(ValueError, match="already registered"):
        register_train_strategy("dp")(lambda degree=2, bug=None: {})
    with pytest.raises(KeyError, match="bad train task"):
        check_train_task("dp")                 # missing the train@ prefix


# ---------------------------------------------------------------------------
# backward capture
# ---------------------------------------------------------------------------

def test_capture_grad_backward_graph():
    """The w2 gradient of sum(tanh(x@w1)@w2) is a transposed-matmul
    program whose single output has w2's shape."""
    from repro_torch.gradcheck.obligations import _AVALS, _NAMES, _loss

    g = capture_grad(_loss, _AVALS, _NAMES, wrt=2, **CPU)
    assert g.n_ops > 0 and len(g.outputs) == 1
    assert g.shapes[g.outputs[0]] == tuple(_AVALS[2].shape)
    ops = {t.op for _, t in g.defs} | {
        op for _, t in g.defs for op in t.ops_used()}
    assert "matmul" in ops and "transpose" in ops   # the AD transpose


@pytest.mark.parametrize("strategy,degree", ALL_DEGREES)
def test_backward_form_is_the_jax_capture(strategy, degree):
    """Each parameter's G_s (torch.func.grad in JAX's backward form) is the
    JAX capture of jax.grad, def for def, and the per-rank G_d has the JAX
    G_d's defs too."""
    mine = get_train_strategy(strategy).build(degree=degree)
    ref = jget_train_strategy(strategy).build(degree=degree)
    for param in mine:
        m, r = mine[param], ref[param]
        gs = capture_backward(m.seq_fn, m.avals, m.input_names, **CPU)
        jgs = jcapture(r.seq_fn, list(r.avals), list(r.input_names))
        assert [(n, PT.pretty(t, 999)) for n, t in gs.defs] == \
            [(n, JT.pretty(t, 999)) for n, t in jgs.defs]
        gd, _ = expand_spmd(capture_grad_spmd(
            m.dist_fn, m.mesh_axes, m.in_specs, m.avals, m.input_names,
            **CPU))
        jgd, _ = jexpand(jcapture_gd(r.dist_fn, r.mesh_axes, r.in_specs,
                                     r.avals, r.input_names))
        assert [(n, PT.pretty(t, 999)) for n, t in gd.defs] == \
            [(n, JT.pretty(t, 999)) for n, t in jgd.defs]


def test_backward_form_leaves_user_transposes_alone():
    """Only autograd's ``t`` feeding a product is rewritten: a user's
    ``x.T @ y`` keeps its transpose def, and outside the form nothing
    changes."""
    from repro_torch.core import capture

    def fn(x, y):
        return x.T @ y
    avals = [((4, 3), torch.float32), ((4, 2), torch.float32)]
    plain = capture(fn, avals, ["x", "y"], **CPU)
    formed = capture_backward(fn, avals, ["x", "y"], **CPU)
    assert [PT.pretty(t, 999) for _, t in plain.defs] == \
        [PT.pretty(t, 999) for _, t in formed.defs] == \
        ["transpose(x, perm=(1, 0))", "matmul(t0, y)"]


# ---------------------------------------------------------------------------
# relation transposition
# ---------------------------------------------------------------------------

def test_grad_collective_transposition():
    mesh = {"dp": 2}
    assert grad_collective(P(), P("dp", None), mesh) == ("psum", ("dp",))
    assert grad_collective(P("dp", None), P("dp", None), mesh) == \
        ("reduce_scatter", ("dp",))
    assert grad_collective(P(), P(), mesh) == ("identity", ())
    assert grad_collective(P(None, "tp"), P("dp", None),
                           {"dp": 2, "tp": 2}) == ("psum", ("dp",))


def test_expected_grad_relation_terms():
    t = expected_grad_relation("g", (4, 4), "f", P(), {"dp": 2})
    assert str(t) == "g@dp0"
    t = expected_grad_relation("g", (2, 4), "f", P("dp", None), {"dp": 2})
    assert str(t) == "concat(g@dp0, g@dp1, dim=0)"


# ---------------------------------------------------------------------------
# engine parity: JAX captures through the port's engine
# ---------------------------------------------------------------------------





ENGINE_TASKS = sorted(BENCH["gradcheck"])


def _task(key):
    _, strategy, deg = key.split("@")
    token = deg[len("deg"):]
    degree = tuple(int(d) for d in token.split("x"))
    return strategy, degree[0] if len(degree) == 1 else degree


@pytest.mark.parametrize("task", ENGINE_TASKS + ["bugs"])
def test_engine_parity_bench_counts(task):
    if task == "bugs":
        runs = [(host, None, bug) for bug, (host, _) in
                sorted(list_train_bugs().items())]
    else:
        runs = [(*_task(task), None)]
    fires = steps = 0
    for strategy, degree, bug in runs:
        specs = jget_train_strategy(strategy).build(degree=degree, bug=bug)
        for param, s in specs.items():
            gs = jcapture(s.seq_fn, list(s.avals), list(s.input_names))
            gd, r_i = jexpand(jcapture_gd(s.dist_fn, s.mesh_axes,
                                          s.in_specs, s.avals,
                                          s.input_names))
            want = outcome(jcheck, JRefinementError, JT.pretty, gs, gd, r_i)
            got = outcome(check_refinement, RefinementError, PT.pretty,
                          *carried(gs, gd, r_i))
            assert got == want, (strategy, param)
            if bug is not None:
                assert got["verdict"] == ("refinement_error" if param == "w2"
                                          else "certificate")
            else:
                fires += sum(got["fires"].values())
                steps += got["explanation"]["total_steps"]
    if task != "bugs":
        bench = BENCH["gradcheck"][task]
        assert (fires, steps) == (bench["lemma_fires"],
                                  bench["explain_steps"])


# ---------------------------------------------------------------------------
# capture parity + clean certification + bug localization
# ---------------------------------------------------------------------------

def _fires(report):
    return {p: (r.get("stats") or {}).get("lemma_fires")
            for p, r in report.reports.items()}


@pytest.mark.parametrize("strategy,degree", ALL_DEGREES)
def test_train_strategy_certifies_as_jax(strategy, degree):
    report = check_train(strategy, degree=degree, **CPU)
    ref = jcheck_train(strategy, degree=degree)
    assert report.ok and report.verdict == "certificate", \
        (strategy, report.failing_params)
    for p in report.params:
        assert p.verdict == "certificate" and p.relation_ok
        assert p.collective.startswith(("psum", "reduce_scatter"))
    assert report.stable_summary() == ref.stable_summary()
    assert {p: r["r_o"] for p, r in report.reports.items()} == \
        {p: r["r_o"] for p, r in ref.reports.items()}
    assert {p: r["relation"] for p, r in report.reports.items()} == \
        {p: r["relation"] for p, r in ref.reports.items()}
    assert _fires(report) == _fires(ref)


@pytest.mark.parametrize("bug", ALL_TRAIN_BUGS)
def test_train_bug_localizes_to_parameter(bug):
    host, bspec = list_train_bugs()[bug]
    target = get_train_strategy(host).bug_params[bug]
    report = check_train(host, bug=bug, **CPU)
    ref = jcheck_train(host, bug=bug)
    assert report.ok, (bug, report.verdict, report.failing_params)
    assert report.verdict == "refinement_error"
    assert report.failing_params == [target] == [report.bug_param] == ["w2"]
    by_param = {p.param: p for p in report.params}
    assert by_param[target].verdict == "refinement_error"
    assert by_param[target].localized_op
    for p in report.params:
        if p.param != target:
            assert p.verdict == "certificate" and p.relation_ok
    assert report.stable_summary() == ref.stable_summary()
    keys = ("op_index", "op_name", "out_name")
    loc, jloc = (r.reports[target]["localization"] for r in (report, ref))
    assert {k: loc[k] for k in keys} == {k: jloc[k] for k in keys}
    assert by_param[target].localized_op == \
        {p.param: p for p in ref.params}[target].localized_op


@pytest.mark.parametrize("bug", [None, "accum_no_rescale"])
def test_explanations_match_jax(bug):
    """--explain's roll-up and each parameter's chain or failure frontier
    (the accum_no_rescale frontier) are the JAX package's."""
    mine = check_train("dp_accum", bug=bug, engine_opts={"explain": True},
                       **CPU)
    ref = jcheck_train("dp_accum", bug=bug, engine_opts={"explain": True})
    assert mine.explanation == ref.explanation
    for param in mine.reports:
        assert mine.reports[param]["explanation"] == \
            ref.reports[param]["explanation"]
    assert mine.explanation["per_obligation"]["w2"]["kind"] == \
        ("failure_frontier" if bug else "certificate")


def test_train_report_json_roundtrip():
    report = check_train("dp", **CPU)
    blob = json.dumps(report.to_json(), sort_keys=True)
    back = TrainReport.from_json(json.loads(blob))
    assert back.stable_summary() == report.stable_summary()
    assert back.task_id() == report.task_id() == "train@dp@deg2"
    md = report.to_markdown()
    assert "psum(dp)" in md and "certificate" in md


def test_check_train_task_api():
    report = check_train_task("train@fsdp", degree=2, **CPU)
    assert report.ok and report.verdict == "certificate"
    assert {p.collective for p in report.params} == {"reduce_scatter(dp)"}


def test_warm_cache_serves_byte_identical_certificates(tmp_path):
    cold = check_train("dp_accum", cache=tmp_path, **CPU)
    warm = check_train("dp_accum", cache=tmp_path, **CPU)
    assert (warm.cache["hits"], warm.cache["misses"]) == (2, 0)
    for param in cold.reports:
        a, b = dict(cold.reports[param]), dict(warm.reports[param])
        a.pop("runtime", None)
        b.pop("runtime", None)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_train("dp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_main(["--train", "dp_accum"])


# ---------------------------------------------------------------------------
# numeric parity and replay
# ---------------------------------------------------------------------------







@pytest.mark.parametrize("strategy", ALL_TRAIN)
def test_gradients_compute_as_jax(strategy):
    """torch.func.grad against jax.grad on the same numpy inputs, and per
    rank the expanded G_d in both packages: within 1e-5 of the output's
    scale in float32."""
    mine = get_train_strategy(strategy).build()
    ref = jget_train_strategy(strategy).build()
    rng = np.random.default_rng(0)
    for param in mine:
        m, r = mine[param], ref[param]
        values = {n: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                  for n, (shape, _) in zip(m.input_names, m.avals)}
        want = np.asarray(r.seq_fn(*(jnp.asarray(values[n])
                                     for n in r.input_names)))
        got = m.seq_fn(*(torch.from_numpy(values[n])
                         for n in m.input_names)).numpy()
        close_to_scale(got, want)
        jgd, _ = jexpand(jcapture_gd(r.dist_fn, r.mesh_axes, r.in_specs,
                                     r.avals, r.input_names))
        gd, _ = expand_spmd(capture_grad_spmd(
            m.dist_fn, m.mesh_axes, m.in_specs, m.avals, m.input_names,
            **CPU))
        shards = shard(values, r.input_names, r.in_specs, r.mesh_axes)
        gw = run(jgd, shards, jeval)
        gt = run(gd, {k: torch.from_numpy(v) for k, v in shards.items()},
                  eval_term)
        assert list(gt) == list(gw)
        for o in gw:
            close_to_scale(gt[o], gw[o])


@pytest.mark.parametrize("strategy,degree", ALL_DEGREES)
def test_certificates_replay(strategy, degree):
    for param, spec in get_train_strategy(strategy).build(
            degree=degree).items():
        got, want = replay_train(spec, "cpu")
        assert set(got) == set(want) and got
        assert max_rel_excess(got, want) <= 1.0, param


# ---------------------------------------------------------------------------
# the versioned --json envelope across the CLI paths
# ---------------------------------------------------------------------------

def _envelope(capsys, main, argv):
    try:
        main(argv)
    except SystemExit as e:               # bug paths exit(1) by design
        assert e.code in (None, 0, 1)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("kind,argv", [
    ("case", ["--case", "tp_layer", "--json"]),
    ("model", ["--model", "gpt", "--plan", "dp2", "--json"]),
    ("train", ["--train", "dp", "--json"]),
])
def test_json_envelope_all_paths(capsys, kind, argv):
    env = _envelope(capsys, verify_main, argv + ["--device", "cpu"])
    assert env["schema_version"] == 2
    assert env["kind"] == kind
    assert set(env) == {"schema_version", "kind", "timing", "report"}
    phases = env["timing"].get("phase_s") or env["timing"].get("phase_s_sum")
    assert phases is not None
    assert set(phases) <= {"saturate", "rebuild", "frontier", "extract"}
    assert {"saturate", "extract"} <= set(phases)
    blob = json.dumps(env, indent=2, sort_keys=True)
    assert json.dumps(json.loads(blob), indent=2, sort_keys=True) == blob


def _stable_envelope(env):
    """Strip timing-dependent fields, keep every certificate byte."""
    env = json.loads(json.dumps(env))
    env.pop("timing", None)
    rep = env["report"]
    for k in ("wall_s", "workers", "timing", "pool"):
        rep.pop(k, None)
    for nested in (rep.get("reports") or {}).values():
        nested.pop("stats", None)
        nested.pop("wall_s", None)
    rep.pop("stats", None)
    return json.dumps(env, sort_keys=True)


@pytest.mark.parametrize("argv", [
    ["--train", "dp_accum", "--json"],
    ["--train", "fsdp", "--inject-bug", "stale_grad_shard", "--json"]],
    ids=["clean", "stale_grad_shard"])
def test_train_envelope_matches_jax(capsys, argv):
    from repro.launch.verify import main as jmain
    env = _envelope(capsys, verify_main, argv + ["--device", "cpu"])
    jenv = _envelope(capsys, jmain, argv)
    assert env["kind"] == jenv["kind"] == "train"
    assert set(env["report"]) == set(jenv["report"])
    assert _stable_envelope(env) == _stable_envelope(jenv)


def test_train_envelope_identical_across_worker_counts(capsys):
    a = _envelope(capsys, verify_main, ["--train", "dp_accum", "--json",
                                        "--workers", "1", "--device", "cpu"])
    b = _envelope(capsys, verify_main, ["--train", "dp_accum", "--json",
                                        "--workers", "2", "--device", "cpu"])
    assert a["report"]["workers"] != b["report"]["workers"]
    assert _stable_envelope(a) == _stable_envelope(b)


def test_cli_train_exit_codes(capsys):
    verify_main(["--train", "dp_accum", "--device", "cpu"])
    assert "TRAIN-STEP REFINEMENT HOLDS" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        verify_main(["--train", "dp_accum", "--inject-bug",
                     "accum_no_rescale", "--device", "cpu"])
    assert e.value.code == 1
    assert "failing parameters ['w2']" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:      # a model bug under --train
        verify_main(["--train", "dp", "--inject-bug", "wrong_spec",
                     "--device", "cpu"])
    assert e.value.code == 2
    assert verify_main(["--train", "tp_dp_2d", "--degree", "4x4",
                        "--device", "cpu"]) is None     # exit 0
    assert "TRAIN-STEP REFINEMENT HOLDS" in capsys.readouterr().out


def test_cli_list_kind_tags(capsys):
    from repro.launch.verify import main as jmain
    verify_main(["--list"])
    out = capsys.readouterr().out
    assert "[case]" in out and "[model]" in out and "[train]" in out
    assert "[serve]" in out and "serve@tp_decode" in out
    assert "train@dp_accum" in out and "accum_no_rescale" in out
    jmain(["--list"])
    ref = capsys.readouterr().out
    # the JAX listing, line for line: cases, models, train and serve tasks
    assert out.splitlines() == ref.splitlines()

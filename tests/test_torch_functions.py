"""The port's generic function frontend and the rest of its verify CLI on
the CPU: ``capture_function``/``run_functions``/``verify_functions``,
``--fn`` on the port's own example, and ``--timeout``/``--workers``/
``--cache``/``--trace``/``--metrics``/``--explain`` on ``--case``, held
against ``run_spec`` (byte-identical certificates for all 11 cases) and
against the JAX package (the example's verdicts and localizations, the
``--json`` envelope's keys).
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch.verify import main as jax_verify_main
from repro_torch import api as tapi
from repro_torch import verify_your_own_fn as example
from repro_torch.api import (build_spec, function_spec, run_functions,
                             run_spec, verify_functions)
from repro_torch.core import (UnsupportedPrimitive, capture,
                              capture_function, capture_spmd_function,
                              normalize_mesh)
from repro_torch.core.from_fx import default_input_names
from repro_torch.core.spmd import PartitionSpec as P
from repro_torch.core.spmd import all_gather, psum
from repro_torch.launch import verify as cli
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import chaos
from repro_torch.runtime.cache import ENV_CACHE_DIR
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
KEYS = ("op_index", "op_name", "out_name")
EXAMPLE = "repro_torch.verify_your_own_fn"


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    for var in (chaos.ENV_SPEC, chaos.ENV_TARGET, chaos.ENV_SEED,
                ENV_CACHE_DIR, "GRAPHGUARD_EXPLAIN"):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# the generic frontend against the registered one: byte-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", tapi.list_strategies())
def test_byte_identical_certificates(case):
    spec = build_spec(case, degree=2, device="cpu")
    golden = run_spec(spec, device="cpu").to_json()
    cert = run_functions(spec.seq_fn, spec.dist_fn, spec.mesh_axes,
                         spec.in_specs, spec.avals, spec.input_names,
                         device="cpu").to_json()
    assert json.dumps(cert["r_o"], sort_keys=True) == \
        json.dumps(golden["r_o"], sort_keys=True)
    for key in ("egraph_nodes", "gs_ops", "gd_ops", "lemma_fires"):
        assert cert["stats"][key] == golden["stats"][key], key


def test_tracing_tensors_are_seeded_and_do_not_change_the_graph():
    """capture_function and the registered path's capture trace on the
    same seeded draw, the same on every run, and give the same graph."""
    spec = build_spec("sp_moe", degree=2, device="cpu")
    avals, names = list(spec.avals), list(spec.input_names)
    g0 = capture_function(spec.seq_fn, avals, device="cpu")
    g1 = capture(spec.seq_fn, avals, names, device="cpu")
    assert repr(g0.defs) == repr(g1.defs)
    seen = []

    def record(*args):
        seen.append([a.clone() for a in args])
        return spec.seq_fn(*args)
    for _ in range(2):
        capture_function(record, avals, names=names, device="cpu")
    capture(record, avals, names, device="cpu")
    for other in seen[1:]:
        assert all(torch.equal(a, b) for a, b in zip(seen[0], other))
    assert any(bool(a.abs().sum() > 0) for a in seen[0])   # not zeros


# ---------------------------------------------------------------------------
# strict contract: the op and the user's file:line
# ---------------------------------------------------------------------------

def _seq_mlp(x, w1, w2):
    return torch.tanh(x @ w1) @ w2


def _dist_mlp(x, w1, w2):
    return psum(torch.tanh(x @ w1) @ w2, "tp")


def _dist_mlp_halved(x, w1, w2):
    return psum(torch.tanh(x @ w1) @ w2, "tp") * 0.5


def _dist_sorted(x, w1, w2):
    return psum(torch.sort(torch.tanh(x @ w1) @ w2, dim=0)[0], "tp")


_AVALS = [(s, torch.float32) for s in ((4, 8), (8, 8), (8, 8))]
_SPECS = (P(), P(None, "tp"), P("tp", None))


def test_unsupported_op_names_its_source():
    line = inspect.getsourcelines(_dist_sorted)[1] + 1
    with pytest.raises(UnsupportedPrimitive) as ei:
        capture_spmd_function(_dist_sorted, {"tp": 2}, _SPECS, _AVALS,
                              device="cpu")
    assert ei.value.primitive == "aten.sort"
    assert f"test_torch_functions.py:{line} (_dist_sorted)" in \
        ei.value.source
    # the raising flavour raises it; verify_functions makes it a verdict
    with pytest.raises(UnsupportedPrimitive):
        run_functions(_seq_mlp, _dist_sorted, {"tp": 2}, _SPECS,
                      avals=_AVALS, device="cpu")
    r = verify_functions(_seq_mlp, _dist_sorted, {"tp": 2}, _SPECS,
                         avals=_AVALS, device="cpu")
    assert r.verdict == "error" and "UnsupportedPrimitive" in r.error
    assert f"test_torch_functions.py:{line}" in r.error


# ---------------------------------------------------------------------------
# verify_functions verdicts and caller mistakes
# ---------------------------------------------------------------------------

def test_verify_functions_verdicts():
    r = verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         avals=_AVALS, device="cpu")
    assert r.verdict == "certificate" and r.ok
    assert r.r_o == {"t2": "t3@tp0"}
    assert r.case == "_dist_mlp" and r.degree == 2
    r = verify_functions(_seq_mlp, _dist_mlp_halved, {"tp": 2}, _SPECS,
                         avals=_AVALS, name="halved", device="cpu")
    assert r.verdict == "refinement_error" and not r.ok
    assert r.case == "halved" and set(KEYS) <= set(r.localization)
    args = [torch.zeros(s, dtype=d) for s, d in _AVALS]
    r = verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         example_args=args, device="cpu")
    assert r.verdict == "certificate"


def test_caller_mistakes_raise_not_verdict(monkeypatch):
    with pytest.raises(ValueError):   # both avals and example_args
        verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         avals=_AVALS, example_args=_AVALS, device="cpu")
    with pytest.raises(ValueError):   # neither
        verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         device="cpu")
    with pytest.raises(ValueError):   # in_specs arity mismatch
        verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, (P(),),
                         avals=_AVALS, device="cpu")
    with pytest.raises(ValueError, match="unknown engine_opts"):
        verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         avals=_AVALS, device="cpu",
                         engine_opts={"bogus": 1})
    with pytest.raises(TypeError):
        verify_functions(_seq_mlp, _dist_mlp, 42, _SPECS, avals=_AVALS,
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_functions(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         avals=_AVALS)


def test_function_spec_defaults():
    spec = function_spec(_seq_mlp, _dist_mlp, {"tp": 2}, _SPECS,
                         avals=_AVALS)
    assert spec.name == "_dist_mlp" and spec.degree == 2
    assert spec.input_names == ("x", "w1", "w2")
    spec2d = function_spec(_seq_mlp, _dist_mlp, {"dp": 2, "tp": 2},
                           _SPECS, avals=_AVALS, name="mlp2d")
    assert spec2d.name == "mlp2d" and spec2d.degree == (2, 2)


def test_default_input_names_fallback():
    assert default_input_names(_seq_mlp, 3) == ["x", "w1", "w2"]
    assert default_input_names(lambda *a: a, 2) == ["arg0", "arg1"]


def test_normalize_mesh_forms():
    assert normalize_mesh({"tp": 2}) == {"tp": 2}
    assert normalize_mesh([("dp", 2), ("tp", 4)]) == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError):
        normalize_mesh({"tp": 0})
    with pytest.raises(TypeError):
        normalize_mesh(42)


# ---------------------------------------------------------------------------
# the port's example against the JAX package's
# ---------------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_your_own_fn",
        os.path.join(ROOT, "examples", "verify_your_own_fn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_matches_the_jax_example():
    from repro.api import verify_functions as jax_verify_functions
    jex = _jax_example()
    jtask = jex.make_task()
    for variant in ("dist_mlp", "dist_mlp_buggy"):
        mine = verify_functions(**{**example.make_task(),
                                   "fn_dist": getattr(example, variant)},
                                device="cpu")
        ref = jax_verify_functions(**{**jtask,
                                      "fn_dist": getattr(jex, variant)})
        assert (mine.verdict, mine.ok) == (ref.verdict, ref.ok), variant
        if ref.localization is not None:
            assert {k: mine.localization[k] for k in KEYS} == \
                {k: ref.localization[k] for k in KEYS}
        else:
            assert mine.r_o == ref.r_o
    assert example.main(["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# the CLI: --fn, runtime flags, observability, envelope parity
# ---------------------------------------------------------------------------

def _run(main, capsys, argv):
    try:
        rc = main(argv) or 0
    except SystemExit as e:
        rc = int(e.code or 0)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_fn_example_task(capsys):
    rc, out, _ = _run(cli.main, capsys, ["--fn", f"{EXAMPLE}:make_task",
                                         "--json", "--device", "cpu"])
    assert rc == 0
    env = json.loads(out)
    assert env["schema_version"] == 2 and env["kind"] == "fn"
    assert env["report"]["verdict"] == "certificate"
    assert env["report"]["case"] == "my_tp_mlp"
    rc, out, _ = _run(cli.main, capsys, ["--fn", f"{EXAMPLE}:make_buggy_task",
                                         "--device", "cpu"])
    assert rc == 1
    assert "REFINEMENT FAILED" in out and '"op_name": "output-filter"' in out


def test_cli_fn_harness_errors_exit_2(capsys):
    for argv in (["--fn", "examples/no_such_file.py:make_task"],
                 ["--fn", "not-a-target"],
                 ["--fn", f"{EXAMPLE}:no_such_callable"],
                 ["--fn", f"{EXAMPLE}:make_task", "--case", "tp_layer"],
                 ["--fn", f"{EXAMPLE}:make_task", "--timeout", "5"]):
        rc, _, _ = _run(cli.main, capsys, argv + ["--device", "cpu"])
        assert rc == 2, argv


def test_fn_task_is_the_dict_form():
    task = example.make_task()
    assert cli._fn_task_kwargs(task) == task
    assert cli._fn_task_kwargs({**task, "strict": False}) == \
        {**task, "strict": False}
    spec = function_spec(**task)
    bad = (
        (spec, "must return a dict"),
        (tuple(task.values()), "must return a dict"),
        ({**task, "stict": False}, "unknown task keys"),
        ({"seq_fn": task["fn_seq"],
          **{k: v for k, v in task.items() if k != "fn_seq"}},
         "unknown task keys"),
        ({k: v for k, v in task.items() if k != "mesh"}, "missing"),
        ({k: v for k, v in task.items() if k != "avals"}, "exactly one"),
        ({**task, "example_args": task["avals"]}, "exactly one"),
    )
    for t, msg in bad:
        with pytest.raises(ValueError, match=msg):
            cli._fn_task_kwargs(t)


_FN_TASK_FILES = {
    "port": """
import torch
from repro_torch.core.spmd import PartitionSpec as P, all_gather

def seq(x):
    return torch.cumprod(x, 0)

def dist(x):
    return all_gather(torch.cumprod(x, 0), "tp", axis=1, tiled=True)

def make_task(**kw):
    return dict(fn_seq=seq, fn_dist=dist, mesh={"tp": 2},
                in_specs=(P(None, "tp"),), avals=[((4, 8), torch.float32)],
                **kw)
""",
    "jax": """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P

def seq(x):
    return jnp.cumprod(x, 0)

def dist(x):
    return jax.lax.all_gather(jnp.cumprod(x, 0), "tp", axis=1, tiled=True)

def make_task(**kw):
    return dict(fn_seq=seq, fn_dist=dist, mesh={"tp": 2},
                in_specs=(P(None, "tp"),),
                avals=[jax.ShapeDtypeStruct((4, 8), jnp.float32)], **kw)
""",
}


def test_cli_fn_strict_key(capsys, tmp_path):
    """A ``--fn`` task's ``strict`` key: an op outside the vocabulary is a
    harness error (exit 2) by default and an opaque op that fails to
    refine (exit 1) with ``"strict": False``, as in the JAX CLI."""
    rcs = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_verify_main, [])):
        path = tmp_path / f"{side}_task.py"
        path.write_text(_FN_TASK_FILES[side] + "\n\ndef make_lenient():\n"
                        "    return make_task(strict=False)\n")
        rcs[side] = [_run(main, capsys, ["--fn", f"{path}:{fn}"] + extra)[0]
                     for fn in ("make_task", "make_lenient")]
    assert rcs["port"] == rcs["jax"] == [2, 1]


def test_cli_fn_takes_a_file_path(capsys):
    path = os.path.join(SRC, "repro_torch", "verify_your_own_fn.py")
    rc, out, _ = _run(cli.main, capsys, ["--fn", f"{path}:make_task",
                                         "--device", "cpu"])
    assert rc == 0 and "REFINEMENT HOLDS — `my_tp_mlp`" in out


@pytest.mark.parametrize("extra", [[], ["--metrics"], ["--explain"],
                                   ["--metrics", "--explain"]])
def test_cli_envelope_keys_match_the_jax_cli(capsys, extra):
    for argv, kind in ((["--case", "sp_rope", "--bug", "rope_offset"],
                        "case"),
                       (["--case", "tp_layer"], "case")):
        _, out, _ = _run(jax_verify_main, capsys, argv + ["--json"] + extra)
        ref = json.loads(out)
        _, out, _ = _run(cli.main, capsys,
                         argv + ["--json", "--device", "cpu"] + extra)
        mine = json.loads(out)
        assert set(mine) == set(ref) and mine["kind"] == ref["kind"] == kind
        assert mine["schema_version"] == ref["schema_version"] == 2
        assert set(mine["timing"]) == set(ref["timing"])
        assert set(mine["report"]) == set(ref["report"])
        if "--explain" in extra:
            # the same kind of explanation, stuck at (or proving) the same
            # op; constants are named by each package's own capture
            m, j = mine["explanation"], ref["explanation"]
            assert (m["kind"], set(m)) == (j["kind"], set(j))
            if "narrative" in j:
                assert m["narrative"][0] == j["narrative"][0]


def test_cli_timeout_runs_the_case_on_a_worker(capsys, tmp_path):
    rc, out, _ = _run(cli.main, capsys, ["--case", "tp_layer", "--json",
                                         "--device", "cpu"])
    inline = json.loads(out)["report"]
    tracer = obs_trace.start("main")
    try:
        rc, out, _ = _run(cli.main, capsys, ["--case", "tp_layer", "--json",
                                             "--device", "cpu", "--timeout",
                                             "120", "--workers", "1"])
    finally:
        obs_trace.stop()
    assert rc == 0
    pooled = json.loads(out)["report"]
    assert pooled["r_o"] == inline["r_o"] and pooled["runtime"] is None
    spans = [e for e in tracer.events if e.get("name") == "task"]
    assert spans and all(e["pid"] != tracer.pid for e in spans)


def test_cli_cache_serves_a_repeat_run(capsys, tmp_path):
    argv = ["--case", "sp_rope", "--bug", "rope_offset", "--json",
            "--device", "cpu", "--cache", str(tmp_path / "c")]
    rc1, out1, _ = _run(cli.main, capsys, argv)
    rc2, out2, _ = _run(cli.main, capsys, argv)
    assert rc1 == rc2 == 1
    cold, warm = json.loads(out1)["report"], json.loads(out2)["report"]
    assert cold["runtime"] == {"cache": "miss"}
    assert warm["runtime"] == {"cache": "hit"}
    assert warm["localization"] == cold["localization"]
    rc, _, _ = _run(cli.main, capsys, argv + ["--no-cache"])
    assert rc == 2                     # the pair is mutually exclusive


def test_cli_trace_metrics_and_report(capsys, tmp_path):
    trace_path = tmp_path / "trace.json"
    rc, out, err = _run(cli.main, capsys, [
        "--case", "tp_layer", "--json", "--device", "cpu", "--trace",
        str(trace_path), "--metrics"])
    assert rc == 0
    env = json.loads(out)
    assert set(env) == {"schema_version", "kind", "timing", "report",
                        "metrics"}
    assert env["metrics"]["counters"].get("engine.runs", 0) >= 1
    assert "-- metrics --" in err and "[obs] wrote" in err
    assert (tmp_path / "trace.json.jsonl").exists()
    assert obs_trace.current() is None
    events = obs_trace.load_events(str(trace_path))
    assert any(e.get("name") == "infer" for e in events)
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report",
                        str(trace_path)], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr
    assert r.stdout.rstrip().splitlines()[-1].startswith("top lemma: ")


def test_cli_explain_prints_the_frontier(capsys):
    rc, out, _ = _run(cli.main, capsys, ["--case", "sp_rope", "--bug",
                                         "rope_offset", "--explain",
                                         "--device", "cpu"])
    assert rc == 1
    assert "[explain] proof provenance:" in out
    assert "refinement stuck at G_s op #2 `mul`" in out
    assert "GRAPHGUARD_EXPLAIN" not in os.environ


@pytest.mark.parametrize("flag,item", [("--model", 6), ("--train", 7),
                                       ("--serve", 8)])
def test_cli_unported_paths_name_their_roadmap_items(flag, item, capsys):
    """--model, --train and --serve (items 6-8) are all ported: each
    refuses an unknown name with exit 2, naming no ROADMAP item."""
    with pytest.raises(SystemExit) as e:
        cli.main([flag, "x", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unknown model `x`" in err or "invalid choice: 'x'" in err
    assert "item" not in err


# ---------------------------------------------------------------------------
# the strict/lenient contract of the JAX frontend (test_from_jaxpr.py), on
# fx: lenient capture keeps an op outside the table as an opaque term (the
# port names it by its aten op, ``opaque:aten.sort``, where jaxpr names the
# primitive, ``opaque:sort``), and a user lemma on it lets the engine
# reason through it, in both packages alike
# ---------------------------------------------------------------------------

def _sorted(x):
    return torch.sort(x, dim=0)[0]


def _jax_sorted():
    import jax
    import jax.numpy as jnp
    return (lambda x: jnp.sort(x, axis=0)), \
        [jax.ShapeDtypeStruct((8,), jnp.float32)]


def _opaque_defs(g):
    return [(t.op, [a.name for a in t.args], t.shape, t.dtype)
            for _, t in g.defs if t.op.startswith("opaque:")]


def test_unknown_primitive_raises_strict_and_is_opaque_lenient():
    from repro.core import UnsupportedPrimitive as JUnsupported
    from repro.core import capture_function as jcapture_function
    line = inspect.getsourcelines(_sorted)[1] + 1
    with pytest.raises(UnsupportedPrimitive) as ei:
        capture_function(_sorted, [((8,), torch.float32)], device="cpu")
    assert ei.value.primitive == "aten.sort"
    assert f"test_torch_functions.py:{line} (_sorted)" in ei.value.source
    fn, avals = _jax_sorted()
    with pytest.raises(JUnsupported) as je:
        jcapture_function(fn, avals)
    assert ei.value.primitive == "aten." + je.value.primitive
    hint = " — pass strict=False to capture it as an uninterpreted opaque op"
    assert hint in str(ei.value) and hint in str(je.value)
    # lenient: the values output is the JAX capture's opaque def (fx's sort
    # also returns the indices, a second opaque output)
    jdefs = _opaque_defs(jcapture_function(fn, avals, strict=False))
    assert jdefs == [("opaque:sort", ["x"], (8,), "f")]
    for g in (capture_function(_sorted, [((8,), torch.float32)],
                               strict=False, device="cpu"),
              capture(_sorted, [((8,), torch.float32)], ["x"],
                      device="cpu")):
        assert _opaque_defs(g) == [("opaque:aten.sort#0", ["x"], (8,), "f"),
                                   ("opaque:aten.sort#1", ["x"], (8,), "i")]
    # the op's other arguments are its attrs: sorting along another dim is
    # another term (jaxpr's opaque term drops its params)
    defs = [t for _, t in capture(
        lambda x: (torch.cumprod(x, 0), torch.cumprod(x, 1)),
        [((4, 4), torch.float32)], ["x"], device="cpu").defs]
    assert [t.attrs for t in defs] == [(("params", ("0",)),),
                                       (("params", ("1",)),)]
    assert defs[0] != defs[1]


def test_strict_hook_is_scoped():
    """After a strict failure the default capture is back to normal: the
    hook stack is empty and the op is an opaque term again."""
    from repro_torch.core.capture import _NODE_HOOKS
    with pytest.raises(UnsupportedPrimitive):
        capture_function(_sorted, [((8,), torch.float32)], device="cpu")
    assert _NODE_HOOKS == []
    g = capture(_sorted, [((8,), torch.float32)], ["x"], device="cpu")
    assert any("opaque:" in repr(t) for _, t in g.defs)


def _seq_cumprod(x):
    return torch.cumprod(x, 0)


def _dist_cumprod(x):
    return all_gather(torch.cumprod(x, 0), "tp", axis=1, tiled=True)


def _jax_cumprod_task():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    def seq(x):
        return jnp.cumprod(x, 0)

    def dist(x):
        return jax.lax.all_gather(jnp.cumprod(x, 0), "tp", axis=1,
                                  tiled=True)
    return dict(fn_seq=seq, fn_dist=dist, mesh={"tp": 2},
                in_specs=(JP(None, "tp"),),
                avals=[jax.ShapeDtypeStruct((4, 8), jnp.float32)])


CUMPROD_TASK = dict(fn_seq=_seq_cumprod, fn_dist=_dist_cumprod,
                    mesh={"tp": 2}, in_specs=(P(None, "tp"),),
                    avals=[((4, 8), torch.float32)])


def _cumprod_lemma(pkg: str):
    """A user lemma, written once for both packages: a cumprod along dim 0
    is the concat of the pieces' cumprods along any other dim."""
    import importlib
    L = importlib.import_module(pkg + ".core.lemmas")
    T = importlib.import_module(pkg + ".core.terms")

    def fn(eg, node, cid):
        (cx,) = node.children
        dtype = eg.info(cid).dtype
        return [(cid, T.concat([T.Term(node.op, (L.cls(eg, x),), node.attrs,
                                       eg.info(x).shape, dtype)
                                for x in xs], dim))
                for dim, xs in L.concat_reps(eg, cx) if dim != 0]
    return L, fn


def test_register_lemma_on_an_opaque_op():
    """A distributed cumprod (sharded along dim 1, gathered) is refused
    strictly, fails to refine leniently with no lemma (nothing reasons
    through the opaque op), and certifies once the user's lemma is
    registered: the same verdicts, localizations and R_o as the JAX
    package's."""
    from repro.api import verify_functions as jverify_functions
    jtask = _jax_cumprod_task()

    def both(**kw):
        return (verify_functions(**CUMPROD_TASK, **kw, device="cpu"),
                jverify_functions(**jtask, **kw))

    mine, ref = both()
    assert mine.verdict == ref.verdict == "error"
    assert "UnsupportedPrimitive" in mine.error
    mine, ref = both(strict=False)
    assert mine.verdict == ref.verdict == "refinement_error"
    loc = {k: mine.localization[k] for k in KEYS}
    assert loc == {**{k: ref.localization[k] for k in KEYS},
                   "op_name": "opaque:aten.cumprod"}
    assert ref.localization["op_name"] == "opaque:cumprod"
    lemmas = []
    try:
        for pkg, op in (("repro_torch", "opaque:aten.cumprod"),
                        ("repro", "opaque:cumprod")):
            L, fn = _cumprod_lemma(pkg)
            lemmas.append((L, L.register_lemma("cumprod_concat", {op}, fn)))
        mine, ref = both(strict=False)
    finally:
        for L, lem in lemmas:
            L._USER_LEMMAS.remove(lem)
    assert mine.verdict == ref.verdict == "certificate"
    assert mine.r_o == ref.r_o
    assert mine.stats["lemma_fires"]["cumprod_concat"] == \
        ref.stats["lemma_fires"]["cumprod_concat"] > 0


def test_supported_primitives_is_a_real_vocabulary():
    """The fx counterparts of the JAX table's core primitives are in the
    port's table, and sort is in neither."""
    from repro.core import SUPPORTED_PRIMITIVES as JSUPPORTED
    from repro_torch.core import SUPPORTED_PRIMITIVES
    pairs = {"dot_general": "aten.mm", "psum": "repro_spmd.psum",
             "all_gather": "repro_spmd.all_gather",
             "reduce_sum": "aten.sum", "concatenate": "aten.cat",
             "tanh": "aten.tanh", "add": "aten.add"}
    assert set(pairs) <= JSUPPORTED
    assert set(pairs.values()) <= SUPPORTED_PRIMITIVES
    assert "sort" not in JSUPPORTED
    assert "aten.sort" not in SUPPORTED_PRIMITIVES


def test_source_location_is_best_effort():
    from repro_torch.core.capture import source_location

    class NoInfo:
        meta = {}
    assert source_location(NoInfo()) == "<unknown>"


def _ssm_loop(x, a):
    h = torch.zeros_like(x[0])
    ys = []
    for t in range(x.shape[0]):
        h = a * h + x[t]
        ys.append(h)
    return torch.stack(ys)


def test_loop_recurrence_unrolls_where_jax_scan_is_over_budget():
    """A JAX recurrence written as ``lax.scan`` is refused past the JAX
    frontend's unroll budget, naming the primitive and the reason. fx has
    no loop primitive: ``make_fx`` unrolls a Python loop, as jax does the
    same loop written in jnp. The port's capture of the torch loop gives
    the JAX capture's defs of the jnp loop (``pretty``, exact; this needed
    ``aten.stack``'s lowering, the jnp.stack defs) and computes the scan's
    values (rtol 1e-6)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import UnsupportedPrimitive as JUnsupported
    from repro.core import capture_function as jcapture_function
    from repro.core.terms import pretty as jpretty
    from repro_torch.core.terms import eval_term, pretty

    def ssm(x, a):
        def step(h, xt):
            h = a * h + xt
            return h, h
        return jax.lax.scan(step, jnp.zeros_like(x[0]), x)[1]

    def ssm_loop(x, a):
        h = jnp.zeros_like(x[0])
        ys = []
        for t in range(x.shape[0]):
            h = a * h + x[t]
            ys.append(h)
        return jnp.stack(ys)

    javals = [jax.ShapeDtypeStruct((16, 4), jnp.float32),
              jax.ShapeDtypeStruct((4,), jnp.float32)]
    with pytest.raises(JUnsupported) as je:
        jcapture_function(ssm, javals)
    assert je.value.primitive == "scan" and "unroll budget" in je.value.reason
    g = capture_function(_ssm_loop, [((16, 4), torch.float32),
                                     ((4,), torch.float32)], device="cpu")
    jg = jcapture_function(ssm_loop, javals)
    assert [pretty(t, 2) for _, t in g.defs] == \
        [jpretty(t, 2) for _, t in jg.defs]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    a = rng.uniform(0.5, 0.9, (4,)).astype(np.float32)
    env = {"x": torch.from_numpy(x), "a": torch.from_numpy(a)}
    env.update(g.consts)
    for name, term in g.defs:
        env[name] = eval_term(term, env)
    (out,) = g.outputs
    np.testing.assert_allclose(env[out].numpy(), np.asarray(ssm(x, a)),
                               rtol=1e-6, atol=1e-6)

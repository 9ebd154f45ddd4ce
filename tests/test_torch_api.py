"""The JAX package's API checks (``tests/test_api.py``) held against the
port's ``repro_torch.api`` and ``repro_torch.launch.verify``.

Every caller mistake raises in the port what it raises in the JAX package:
the same exception class and the same message, the package's own module
name aside (``repro_torch`` for ``repro``). Specs, degrees, task ids and
the suite's matrix are compared with the JAX package's values exactly; the
strategy families' verdicts, localizations and R_o shapes are the JAX
test's assertions made on the port's own captures (on the CPU), with R_o
equal to the JAX package's up to a renaming of ``t<N>`` names.
"""
import json

import pytest

from repro import api as japi
from repro.api.registry import _REGISTRY as _JREGISTRY
from repro.launch.verify import CASES as JCASES
from repro.launch.verify import run_case as jrun_case

from repro_torch.api import (BugSpec, DuplicateStrategyError, Report,
                             StrategySpec, Suite, axis_degrees, build_spec,
                             bug_host, degree_token, get_strategy,
                             list_strategies, normalize_degree, parse_degree,
                             register_strategy, verify)
from repro_torch.api.registry import _REGISTRY
from repro_torch.api.report import same_up_to_renaming
from repro_torch.api.spec import task_id
from repro_torch.core.profile import CONFIG
from repro_torch.launch.verify import CASES, run_case
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ALL_CASES = list_strategies()
CPU = {"device": "cpu"}


def _same_error(port_call, jax_call):
    """Both calls raise: same class name, same message up to the package
    name. Returns the port's exception."""
    with pytest.raises(Exception) as pe:
        port_call()
    with pytest.raises(Exception) as je:
        jax_call()
    assert type(pe.value).__name__ == type(je.value).__name__
    assert str(pe.value).replace("repro_torch", "repro") == str(je.value)
    return pe.value


def _never(degree=2, bug=None, device=None):  # pragma: no cover
    raise AssertionError("never built")


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_duplicate_registration_raises():
    e = _same_error(lambda: register_strategy("tp_layer")(_never),
                    lambda: japi.register_strategy("tp_layer")(_never))
    assert isinstance(e, DuplicateStrategyError)


def test_duplicate_bug_name_raises():
    e = _same_error(
        lambda: register_strategy(
            "_thief", bugs=[BugSpec("rope_offset")])(_never),
        lambda: japi.register_strategy(
            "_thief", bugs=[japi.BugSpec("rope_offset")])(_never))
    assert isinstance(e, DuplicateStrategyError) and "rope_offset" in str(e)
    assert "_thief" not in list_strategies()
    assert "_thief" not in japi.list_strategies()


def test_register_rejects_bad_expectation():
    e = _same_error(
        lambda: register_strategy("nope", expected="refinement_error"),
        lambda: japi.register_strategy("nope", expected="refinement_error"))
    assert isinstance(e, ValueError)
    e = _same_error(lambda: BugSpec("b", expected="certificate"),
                    lambda: japi.BugSpec("b", expected="certificate"))
    assert isinstance(e, ValueError)


@pytest.mark.parametrize("call", ["get_strategy", "build_spec", "bug_host"])
def test_unknown_names_raise(call):
    name = "no_such_bug" if call == "bug_host" else "no_such_case"
    kw = CPU if call == "build_spec" else {}
    port = {"get_strategy": get_strategy, "build_spec": build_spec,
            "bug_host": bug_host}[call]
    e = _same_error(lambda: port(name, **kw),
                    lambda: getattr(japi, call)(name))
    assert isinstance(e, KeyError)


@pytest.mark.parametrize("entry", ["verify", "build_spec", "run_case"])
def test_wrong_host_bug_guard(entry):
    """Running a bug under the wrong case would silently verify the clean
    graph: the guard fires through every entry point, as in JAX."""
    port = {"verify": lambda: verify("tp_layer", bug="rope_offset", **CPU),
            "build_spec": lambda: build_spec("tp_layer", bug="rope_offset",
                                             **CPU),
            "run_case": lambda: run_case("tp_layer", bug="rope_offset",
                                         quiet=True, **CPU)}[entry]
    ref = {"verify": lambda: japi.verify("tp_layer", bug="rope_offset"),
           "build_spec": lambda: japi.build_spec("tp_layer",
                                                 bug="rope_offset"),
           "run_case": lambda: jrun_case("tp_layer", bug="rope_offset",
                                         quiet=True)}[entry]
    e = _same_error(port, ref)
    assert isinstance(e, ValueError) and "belongs to case" in str(e)


def test_legacy_cases_view_mirrors_registry():
    assert set(CASES) == set(ALL_CASES) == set(JCASES)
    seq_fn, dist_fn, axes, specs, avals, names = CASES["tp_layer"](
        degree=2, **CPU)
    assert callable(seq_fn) and callable(dist_fn)
    assert axes == {"tp": 2} and names == ["x", "w1", "w2"]
    jtup = tuple(JCASES["tp_layer"](degree=2))
    assert (axes, [tuple(s) for s in specs], names) == \
        (jtup[2], [tuple(s) for s in jtup[3]], jtup[5])


def test_run_case_defaults_to_the_card_and_prints_as_jax(capsys,
                                                         monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_case("tp_layer", quiet=True)
    cert = run_case("tp_layer", **CPU)
    out = capsys.readouterr().out.splitlines()
    jcert = jrun_case("tp_layer")
    jout = capsys.readouterr().out.splitlines()
    assert out[0] == jout[0] and out[1] == jout[1] == "R_o certificate:"
    assert out[2:-1] == jout[2:-1]
    assert out[-1].endswith(f"{cert.stats['egraph_nodes']} e-nodes)")
    assert cert.stats["egraph_nodes"] == jcert.stats["egraph_nodes"]


# jax's dynamic_slice clamp and jnp.pad's convert add defs: these two cases'
# t<N> names differ from the JAX capture's by a renaming
RENAMED = {"sp_rope", "sp_pad"}


@pytest.mark.parametrize("case", ALL_CASES)
def test_run_case_is_the_jax_run_case(case):
    """Every registered case at degree 2: the JAX run_case's pretty(R_o)
    (up to renaming where the captures number defs apart) and fires."""
    from repro.core.terms import pretty as jpretty
    from repro_torch.core.terms import pretty
    cert = run_case(case, degree=2, quiet=True, **CPU)
    jcert = jrun_case(case, degree=2, quiet=True)
    assert cert.r_o and all(e.is_clean() for e in cert.r_o.values())
    got = {k: pretty(v, 999) for k, v in cert.r_o.items()}
    want = {k: jpretty(v, 999) for k, v in jcert.r_o.items()}
    assert got == want if case not in RENAMED else \
        same_up_to_renaming(got, want)
    assert cert.stats["lemma_fires"] == jcert.stats["lemma_fires"]


# ---------------------------------------------------------------------------
# StrategySpec
# ---------------------------------------------------------------------------

def test_spec_is_frozen_and_stamped():
    spec = build_spec("sp_rope", degree=4, bug="rope_offset", **CPU)
    jspec = japi.build_spec("sp_rope", degree=4, bug="rope_offset")
    assert isinstance(spec, StrategySpec)
    assert (spec.name, spec.degree, spec.bug) == ("sp_rope", 4, "rope_offset")
    assert spec.expected == jspec.expected == "refinement_error"
    assert spec.task_id() == jspec.task_id() == "sp_rope@deg4+rope_offset"
    with pytest.raises(Exception) as pe:
        spec.degree = 2
    with pytest.raises(Exception) as je:
        jspec.degree = 2
    assert type(pe.value).__name__ == type(je.value).__name__ == \
        "FrozenInstanceError"


def test_spec_iterates_as_legacy_6tuple():
    spec = build_spec("ep_moe", **CPU)
    tup = tuple(spec)
    assert len(tup) == 6
    assert tup[2] == {"ep": 2} and tup[5] == ["x", "w"]
    assert spec.as_tuple()[0] is spec.seq_fn
    jtup = tuple(japi.build_spec("ep_moe"))
    assert (tup[2], tup[5]) == (jtup[2], jtup[5])


# ---------------------------------------------------------------------------
# multi-axis degree plumbing
# ---------------------------------------------------------------------------

def test_degree_normalization_and_tokens():
    for d in (4, [2, 4], (4,), (2, 2, 2)):
        assert normalize_degree(d) == japi.normalize_degree(d)
        assert degree_token(d) == japi.degree_token(d)
    assert normalize_degree(4) == 4
    assert normalize_degree([2, 4]) == (2, 4)
    assert normalize_degree((4,)) == 4
    assert degree_token(4) == "4"
    assert degree_token([4, 2]) == "4x2"
    assert task_id("tp_dp_2d", (2, 4)) == "tp_dp_2d@deg2x4"
    assert task_id("tp_dp_2d", (2, 4), "psum_wrong_axis") == \
        japi.task_id("tp_dp_2d", (2, 4), "psum_wrong_axis") == \
        "tp_dp_2d@deg2x4+psum_wrong_axis"


@pytest.mark.parametrize("bad", ["x", "2x", "a", "2xa", "", "0", "-2", "2x0",
                                 "2x-1"])
def test_parse_degree_cli_values(bad):
    assert parse_degree("4") == 4
    assert parse_degree("2x4") == (2, 4)
    assert parse_degree("2x2x2") == (2, 2, 2)
    e = _same_error(lambda: parse_degree(bad),
                    lambda: japi.parse_degree(bad))
    assert isinstance(e, ValueError) and "bad degree" in str(e)


@pytest.mark.parametrize("call", ["build_spec", "verify", "Suite", "arity"])
def test_tuple_degree_rejected_for_single_axis_cases(call):
    port, ref = {
        "build_spec": (lambda: build_spec("tp_layer", degree=(2, 4), **CPU),
                       lambda: japi.build_spec("tp_layer", degree=(2, 4))),
        "verify": (lambda: verify("sp_moe", degree=(2, 2), **CPU),
                   lambda: japi.verify("sp_moe", degree=(2, 2))),
        "Suite": (lambda: Suite(degrees=[(2, 4)]),
                  lambda: japi.Suite(degrees=[(2, 4)])),
        "arity": (lambda: build_spec("tp_dp_2d", degree=(2, 2, 2), **CPU),
                  lambda: japi.build_spec("tp_dp_2d", degree=(2, 2, 2))),
    }[call]
    e = _same_error(port, ref)
    assert isinstance(e, ValueError)
    assert ("-axis degrees" if call == "arity" else "single-axis") in str(e)


def test_axis_degrees_broadcast_and_mismatch():
    assert axis_degrees(4, 2) == (4, 4)
    assert axis_degrees((4, 2), 2) == (4, 2)
    e = _same_error(lambda: axis_degrees((4, 2), 3),
                    lambda: japi.axis_degrees((4, 2), 3))
    assert "2 entries for a 3-axis" in str(e)


def test_multiaxis_spec_stamping_and_legacy_tuple():
    spec = build_spec("tp_dp_2d", degree=[4, 2], **CPU)
    assert spec.degree == (4, 2)
    assert spec.task_id() == "tp_dp_2d@deg4x2"
    seq_fn, dist_fn, axes, specs, avals, names = spec
    assert callable(seq_fn) and callable(dist_fn)
    assert axes == {"dp": 4, "tp": 2}
    assert names == ["x", "w1", "w2"]
    assert build_spec("tp_dp_2d", degree=2, **CPU).mesh_axes == \
        japi.build_spec("tp_dp_2d", degree=2).mesh_axes == {"dp": 2, "tp": 2}


def test_multiaxis_report_json_roundtrip():
    report = verify("tp_dp_2d", degree=(2, 2), **CPU)
    assert report.ok and report.degree == (2, 2)
    back = Report.from_json(json.loads(json.dumps(report.to_json())))
    assert back.degree == (2, 2)
    assert back.task_id() == report.task_id() == "tp_dp_2d@deg2x2"
    jrep = japi.verify("tp_dp_2d", degree=(2, 2))
    assert same_up_to_renaming(report.r_o, jrep.r_o)
    assert set(report.to_json()) == set(jrep.to_json())


def test_suite_sweeps_tuple_degrees_from_registry():
    ids = [t.task_id() for t in
           Suite(cases=["tp_dp_2d"], include_bugs=True).tasks()]
    assert ids == [t.task_id() for t in japi.Suite(
        cases=["tp_dp_2d"], include_bugs=True).tasks()]
    assert ids == ["tp_dp_2d@deg2x2", "tp_dp_2d@deg2x2+psum_wrong_axis",
                   "tp_dp_2d@deg2x4", "tp_dp_2d@deg2x4+psum_wrong_axis",
                   "tp_dp_2d@deg4x2", "tp_dp_2d@deg4x2+psum_wrong_axis",
                   "tp_dp_2d@deg4x4", "tp_dp_2d@deg4x4+psum_wrong_axis"]


# ---------------------------------------------------------------------------
# the FSDP / pipeline / 2D-mesh families on the port's captures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [2, 4])
def test_fsdp_bugs_detected(degree):
    clean = verify("fsdp_mlp", degree=degree, **CPU)
    assert clean.ok and clean.verdict == "certificate"
    stale = verify("fsdp_mlp", degree=degree, bug="stale_shard", **CPU)
    assert stale.ok and stale.verdict == "refinement_error"
    assert stale.localization["op_name"] == "matmul"
    wrong = verify("fsdp_mlp", degree=degree, bug="rs_wrong_axis", **CPU)
    assert wrong.ok and wrong.verdict == "certificate"
    assert wrong.r_o != clean.r_o
    (grad_out,) = [k for k, v in wrong.r_o.items() if "dim=1" in v]
    assert "dim=0" in clean.r_o[grad_out]
    jwrong = japi.verify("fsdp_mlp", degree=degree, bug="rs_wrong_axis")
    assert same_up_to_renaming(wrong.r_o, jwrong.r_o)


@pytest.mark.parametrize("degree", [2, 4])
def test_pp_dropped_microbatch_detected(degree):
    clean = verify("pp_stage", degree=degree, **CPU)
    assert clean.ok and clean.verdict == "certificate"
    assert list(clean.r_o.values())[0].endswith(f"@pp{degree - 1}")
    bug = verify("pp_stage", degree=degree, bug="drop_microbatch", **CPU)
    assert bug.ok and bug.verdict == "refinement_error"


def test_tp_dp_2d_wrong_axis_detected():
    bug = verify("tp_dp_2d", degree=(2, 2), bug="psum_wrong_axis", **CPU)
    assert bug.ok and bug.verdict == "refinement_error"


@pytest.mark.parametrize("degree", [(2, 4), (4, 2), (4, 4)])
def test_tp_dp_2d_degree4_axes(degree):
    clean = verify("tp_dp_2d", degree=degree, **CPU)
    assert clean.ok and clean.verdict == "certificate"
    bug = verify("tp_dp_2d", degree=degree, bug="psum_wrong_axis", **CPU)
    assert bug.ok and bug.verdict == "refinement_error"


# ---------------------------------------------------------------------------
# verify() and the suite: caller mistakes, engine opts, the matrix
# ---------------------------------------------------------------------------

def test_verify_rejects_selectors_with_prebuilt_spec():
    spec = build_spec("sp_moe", degree=4, **CPU)
    jspec = japi.build_spec("sp_moe", degree=4)
    assert verify(spec, **CPU).ok
    for kw in ({"degree": 8}, {"bug": "rope_offset"}):
        e = _same_error(lambda: verify(spec, **kw, **CPU),
                        lambda: japi.verify(jspec, **kw))
        assert isinstance(e, ValueError) and "already built" in str(e)


@pytest.mark.parametrize("kw", [{"bugs": ["rope_offzet"]},
                                {"cases": ["tp_layer"],
                                 "bugs": ["rope_offset"]}],
                         ids=["unknown", "never_run"])
def test_suite_rejects_bad_bug_filters(kw):
    e = _same_error(lambda: Suite(**kw), lambda: japi.Suite(**kw))
    assert ("unknown bug" if "cases" not in kw else "never run") in str(e)


def test_report_json_roundtrip():
    report = verify("tp_layer", **CPU)
    blob = json.dumps(report.to_json(), sort_keys=True)
    back = Report.from_json(json.loads(blob))
    assert back.to_json() == report.to_json()
    assert back.certificate is None
    assert set(report.to_json()) == set(japi.verify("tp_layer").to_json())


def test_engine_opts_restored_after_verify():
    before = CONFIG.as_dict()
    verify("ln_grad", engine_opts={"optimizations": False}, **CPU)
    assert CONFIG.as_dict() == before
    e = _same_error(
        lambda: verify("ln_grad", engine_opts={"max_nodez": 5}, **CPU),
        lambda: japi.verify("ln_grad", engine_opts={"max_nodez": 5}))
    assert isinstance(e, ValueError) and "unknown engine_opts" in str(e)


# ---------------------------------------------------------------------------
# Suite
# ---------------------------------------------------------------------------

def test_suite_matrix_shape():
    tasks = Suite(include_bugs=True).tasks()
    by_id = [t.task_id() for t in tasks]
    assert by_id == [t.task_id()
                     for t in japi.Suite(include_bugs=True).tasks()]
    assert len(by_id) == len(set(by_id))
    for t in tasks:
        if t.bug is not None:
            assert bug_host(t.bug) == t.case
        assert t.degree in get_strategy(t.case).degrees
    assert "grad_accum@deg8" not in by_id
    assert "ln_grad@deg2+ln_no_allreduce" in by_id


def test_suite_deterministic_across_opt():
    """Byte-identical stable summaries with every engine optimization on
    and off (across worker counts: test_torch_suite.py's pooled test)."""
    cases = ["tp_layer", "sp_moe", "ln_grad"]
    summaries = []
    for opts in (True, False):
        s = Suite(cases=cases, degrees=(2,),
                  engine_opts={"optimizations": opts})
        summaries.append(json.dumps(s.run(workers=0, **CPU).stable_summary(),
                                    sort_keys=True))
    assert len(set(summaries)) == 1


def test_suite_per_task_timeout():
    """A wedged task is reported as verdict=timeout without sinking the
    rest of the matrix. The case's build sleeps 30 s on its spawned worker
    (``torch_sleepy_strategy``); the budget, 8 s from the task's start,
    leaves ln_grad (~0.1 s on a warmed worker) far inside its own."""
    import importlib
    import sys
    sys.modules.pop("torch_sleepy_strategy", None)
    importlib.import_module("torch_sleepy_strategy")
    try:
        with Suite(cases=["_sleepy", "ln_grad"], degrees=(2,)) as s:
            result = s.run(workers=2, timeout_s=8.0, **CPU)
        by_case = {r.case: r for r in result}
        assert by_case["_sleepy"].verdict == "timeout"
        assert not by_case["_sleepy"].ok
        assert by_case["ln_grad"].verdict == "certificate"
        assert not result.ok
    finally:
        _REGISTRY.pop("_sleepy", None)
        sys.modules.pop("torch_sleepy_strategy", None)
    assert "_sleepy" not in _JREGISTRY

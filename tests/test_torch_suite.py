"""The port's suite runner (``repro_torch.api.Suite`` and
``python -m repro_torch.api``) on the CPU, against the JAX package's
``Suite``: the same verdicts, expectations, localizations and per-lemma
fires at degrees 2 and 4, clean and bugged, with R_o equal up to a
renaming of ``t<N>`` names; pooled (spawned workers) equal to in-process;
the certificate cache, chaos and tracing through the suite; the registry
under spawn; and the golden gate.

Every task that should succeed has a budget of at least 60 s.
"""
import importlib
import json
import os
import sys

import pytest
import torch

from repro.api import Suite as JaxSuite
from repro_torch.api import Suite, register_strategy
from repro_torch.api import suite as tsuite
from repro_torch.api.registry import _REGISTRY
from repro_torch.api.report import same_up_to_renaming
from repro_torch.obs import inspect as obs_inspect
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import CertificateCache, chaos
from repro_torch.runtime.cache import ENV_CACHE_DIR
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "suite_degree2.json")
DEGREES = (2, 4)
KEYS = ("op_index", "op_name", "out_name")


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    for var in (chaos.ENV_SPEC, chaos.ENV_TARGET, chaos.ENV_SEED,
                ENV_CACHE_DIR):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def inline():
    """The port's matrix at degrees 2 and 4 with every bug, in-process."""
    return Suite(degrees=DEGREES, include_bugs=True).run(workers=0,
                                                         device="cpu")


@pytest.fixture(scope="module")
def jax_inline():
    return JaxSuite(degrees=DEGREES, include_bugs=True).run(workers=0)


def _summaries(result):
    return {r.task_id(): json.dumps(r.stable_summary(), sort_keys=True)
            for r in result}


def test_suite_matches_the_jax_suite(inline, jax_inline):
    mine = {r.task_id(): r for r in inline}
    ref = {r.task_id(): r for r in jax_inline}
    assert list(mine) == list(ref)
    assert inline.ok and jax_inline.ok
    for key, j in ref.items():
        r = mine[key]
        assert (r.verdict, r.expected, r.ok) == (j.verdict, j.expected,
                                                 j.ok), key
        if j.localization is not None:
            assert {k: r.localization[k] for k in KEYS} == \
                {k: j.localization[k] for k in KEYS}, key
        assert (r.r_o is None) == (j.r_o is None), key
        if j.r_o is not None:
            assert same_up_to_renaming(r.r_o, j.r_o), (key, r.r_o, j.r_o)
        if j.stats is not None:
            assert r.stats["lemma_fires"] == j.stats["lemma_fires"], key


def test_pooled_suite_equals_in_process(inline):
    """Spawned workers (tracing on the CPU) give every task the
    in-process stable summary; results keep the matrix order, and the
    runtime's queue/run aggregate stays out of the stable view."""
    with Suite(degrees=DEGREES, include_bugs=True) as s:
        pooled = s.run(workers=3, timeout_s=120.0, device="cpu")
        assert s._pool.device == "cpu" and s._pool.workers == 3
    assert [r.task_id() for r in pooled] == [r.task_id() for r in inline]
    assert _summaries(pooled) == _summaries(inline)
    assert not any(r.runtime for r in pooled)
    assert pooled.summary()["runtime"]["tasks"] == len(inline)
    assert "runtime" not in json.dumps(pooled.stable_summary())


def test_device_resolves_in_the_caller(monkeypatch):
    """Without a card and without device=, the run raises once, before
    any worker starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Suite(cases=["tp_layer"], degrees=(2,)) as s:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s.run(workers=2)
        assert s._pool is None


def test_cache_warm_run_identical_and_torn_line_reproved(tmp_path):
    d = tmp_path / "c"
    suite = Suite(cases=["tp_layer", "sp_rope"], degrees=(2,),
                  include_bugs=True)
    cold = suite.run(workers=0, cache=d, device="cpu")
    assert (cold.cache["misses"], cold.cache["hits"]) == (len(cold), 0)
    warm = suite.run(workers=0, cache=d, device="cpu")
    assert (warm.cache["hits"], warm.cache["misses"]) == (len(cold), 0)
    assert _summaries(warm) == _summaries(cold)
    for r in warm:
        assert r.runtime == {"cache": "hit"}
    # tear the journal's last line (the writer died mid-commit)
    path = CertificateCache(d).journal_path
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-10])
    again = suite.run(workers=0, cache=d, device="cpu")
    assert again.cache["misses"] == 1
    assert again.cache["hits"] == len(cold) - 1
    assert again.cache["recovered_corrupt"] == 1
    assert _summaries(again) == _summaries(cold)


def test_suite_crash_charged_to_the_victim_only(monkeypatch, inline):
    monkeypatch.setenv(chaos.ENV_SPEC, "crash:1")
    monkeypatch.setenv(chaos.ENV_TARGET, "tp_layer@deg2")
    with Suite(cases=["tp_layer", "sp_rope"], degrees=(2,)) as s:
        hit = s.run(workers=2, timeout_s=120.0, device="cpu")
    by = {r.task_id(): r for r in hit}
    victim = by["tp_layer@deg2"]
    assert victim.verdict == "error" and not victim.ok
    assert "SIGSEGV" in victim.error
    assert victim.runtime["attempts"] == 3
    assert _summaries(hit)["sp_rope@deg2"] == \
        _summaries(inline)["sp_rope@deg2"]


def test_suite_hang_times_out_on_its_budget(monkeypatch):
    """The budget starts when the task starts on its (warmed) worker; the
    only task is the victim, so no other task meets the short budget."""
    monkeypatch.setenv(chaos.ENV_SPEC, "hang:1")
    monkeypatch.setenv(chaos.ENV_TARGET, "ln_grad@deg2")
    with Suite(cases=["ln_grad"], degrees=(2,)) as s:
        res = s.run(workers=2, timeout_s=3.0, device="cpu")
    (r,) = res.reports
    assert r.verdict == "timeout" and not r.ok
    assert "budget" in r.error


def test_pooled_trace_has_one_track_per_worker(tmp_path, capsys):
    tracer = obs_trace.start("main")
    with Suite(cases=["tp_layer", "sp_moe"], degrees=(2,)) as s:
        res = s.run(workers=2, timeout_s=120.0, device="cpu")
    obs_trace.stop()
    assert res.ok
    spans = [e for e in tracer.events
             if e.get("name") == "task" and e.get("ph") == "X"]
    assert len(spans) == 2
    assert tracer.pid not in {e["pid"] for e in spans}
    for e in spans:
        a = e["args"]
        assert a["worker_pid"] == e["pid"] and a["device"] == "cpu"
        assert a["cuda_initialized"] is False
        assert a["launches"] and not any(a["launches"].values())
    path = tmp_path / "t.json"
    tracer.write_chrome(str(path))
    assert obs_inspect.report(str(path)) == 0
    assert "top lemma: " in capsys.readouterr().out


def test_case_registered_by_a_users_module_runs_pooled():
    sys.modules.pop("torch_suite_strategy", None)
    importlib.import_module("torch_suite_strategy")
    try:
        assert tsuite.registering_module("user_tp_mlp") == \
            "torch_suite_strategy"
        with Suite(cases=["user_tp_mlp"], include_bugs=True) as s:
            res = s.run(workers=2, timeout_s=120.0, device="cpu")
        by = {r.task_id(): r for r in res}
        assert by["user_tp_mlp@deg2"].r_o == {"t2": "t3@tp0"}
        bug = by["user_tp_mlp@deg2+user_psum_as_mean"]
        assert bug.verdict == "refinement_error" and bug.ok
    finally:
        _REGISTRY.pop("user_tp_mlp", None)
        sys.modules.pop("torch_suite_strategy", None)


@pytest.mark.parametrize("module", ["__main__", "no_such_module_anywhere"])
def test_case_a_worker_cannot_import_raises_in_the_caller(module):
    def builder(degree=2, bug=None, device=None):
        raise AssertionError("never built")
    builder.__module__ = module
    register_strategy("user_unimportable", degrees=(2,))(builder)
    try:
        with Suite(cases=["user_unimportable"]) as s:
            with pytest.raises(ValueError, match="cannot import"):
                s.run(workers=2, device="cpu")
            assert s._pool is None
    finally:
        _REGISTRY.pop("user_unimportable", None)


def _golden_with_renamed_tensors(tmp_path):
    """The JAX golden with every t<N> name shifted by 100: equal up to
    renaming, different byte for byte."""
    import re
    golden = json.load(open(GOLDEN))
    shift = lambda s: re.sub(r"\bt(\d+)\b",  # noqa: E731
                             lambda m: f"t{int(m.group(1)) + 100}", s)
    renamed = {k: {**v, "r_o": {shift(a): shift(b)
                                for a, b in v["r_o"].items()}}
               for k, v in golden.items()}
    path = tmp_path / "renamed.json"
    path.write_text(json.dumps(renamed))
    return golden, renamed, path


def test_cli_check_holds_r_o_up_to_renaming(tmp_path, capsys):
    assert tsuite.main(["--degrees", "2", "--device", "cpu", "--workers",
                        "0", "--check", GOLDEN]) == 0
    golden, renamed, path = _golden_with_renamed_tensors(tmp_path)
    assert renamed != golden
    assert tsuite.main(["--degrees", "2", "--device", "cpu", "--workers",
                        "0", "--check", str(path)]) == 0
    # a changed relation, verdict or localization is a mismatch
    bad = dict(golden)
    bad["tp_layer@deg2"] = {**bad["tp_layer@deg2"],
                            "r_o": {"t2": "t3@tp1"}}
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(bad))
    assert tsuite.main(["--cases", "tp_layer", "--degrees", "2",
                        "--device", "cpu", "--workers", "0",
                        "--check", str(bad_path)]) == 1
    err = capsys.readouterr().err
    assert "GOLDEN MISMATCH" in err and "tp_layer@deg2" in err


def test_golden_mismatches_compares_everything_else_exactly():
    a = {"verdict": "refinement_error", "expected": "refinement_error",
         "ok": True, "localization": {"op_index": 2, "op_name": "mul",
                                      "out_name": "t2"}}
    b = {**a, "localization": {**a["localization"], "out_name": "t7"}}
    assert tsuite.golden_mismatches({"x": a}, {"x": a})["changed"] == []
    assert tsuite.golden_mismatches({"x": a}, {"x": b})["changed"] == ["x"]
    diff = tsuite.golden_mismatches({"x": a}, {"y": a})
    assert (diff["missing"], diff["extra"]) == (["y"], ["x"])


def test_cli_write_golden_needs_a_path(tmp_path):
    with pytest.raises(SystemExit):
        tsuite.main(["--write-golden"])
    out = tmp_path / "g.json"
    assert tsuite.main(["--cases", "ln_grad", "--degrees", "2", "--device",
                        "cpu", "--workers", "0", "--write-golden",
                        str(out), "--json", str(tmp_path / "r.json")]) == 0
    assert list(json.load(open(out))) == ["ln_grad@deg2"]
    assert json.load(open(tmp_path / "r.json"))["summary"]["ok"] == 1

"""The JAX package's proof-provenance checks (``tests/test_explain.py``)
held against the port's ``repro_torch.core.explain``.

Reports without explain carry no ``explanation`` key, for a case and for
the family reports; the explicit option beats ``GRAPHGUARD_EXPLAIN``;
explain-on cache entries are apart. A certificate's lemma chain replays
outside the e-graph (on the CPU) and a tampered step is refused. The
chain is the same across engine optimization modes, worker counts and
hash seeds, and equal to the JAX package's chain for the same case: two
fresh interpreters under ``PYTHONHASHSEED=1`` and ``2`` print the same
``tp_dp_2d`` chain, which is the JAX package's. Failure frontiers name the
stuck operator, aggregation rolls per-obligation chains up, the CLI
envelope carries ``explanation`` only under ``--explain``, and the gzip
traces and the obs JSON report round-trip.
"""
import gzip
import json
import os
import subprocess
import sys

import pytest

from repro.api import verify as jverify

from repro_torch.api import verify
from repro_torch.core.explain import (aggregate_explanations,
                                      check_explanation, explanation_steps,
                                      render_narrative)
from repro_torch.core.profile import CONFIG, explain_enabled, \
    set_optimizations
from repro_torch.gradcheck import check_train
from repro_torch.launch.verify import main as verify_main
from repro_torch.modelcheck import check_model
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.inspect import report, to_json_report
from repro_torch.servecheck import check_serve
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}



def _expl(case, **kw):
    rep = verify(case, engine_opts={"explain": True}, **CPU, **kw)
    assert rep.verdict == "certificate"
    assert rep.explanation is not None
    return rep.explanation


def _jexpl(case, **kw):
    return jverify(case, engine_opts={"explain": True}, **kw).explanation


def _dump(expl):
    return json.dumps(expl, sort_keys=True)


# -- behaviour neutrality -----------------------------------------------------

def test_off_report_has_no_explanation_key():
    rep = verify("tp_layer", **CPU)
    assert rep.explanation is None
    assert "explanation" not in rep.to_json()


def test_off_on_certificates_identical():
    off = verify("tp_layer", **CPU)
    on = verify("tp_layer", engine_opts={"explain": True}, **CPU)
    assert off.r_o == on.r_o
    for k in ("egraph_nodes", "gs_ops", "gd_ops", "lemma_fires"):
        assert off.stats[k] == on.stats[k]


def test_off_family_reports_have_no_explanation_key():
    rep = check_train("dp", **CPU)
    assert rep.explanation is None
    assert "explanation" not in rep.to_json()
    assert all("explanation" not in r for r in rep.reports.values())


def test_explain_enabled_override_beats_env(monkeypatch):
    monkeypatch.setenv("GRAPHGUARD_EXPLAIN", "1")
    assert explain_enabled() is True
    assert explain_enabled(False) is False
    monkeypatch.delenv("GRAPHGUARD_EXPLAIN")
    assert explain_enabled() is False
    assert explain_enabled(True) is True


def test_engine_token_isolates_explain_cache_entries():
    from repro.runtime.cache import _engine_token as _jtoken
    from repro_torch.runtime.cache import _engine_token
    assert _engine_token({"explain": True}) != _engine_token(None)
    assert _engine_token({"explain": True}).endswith(":xp")
    for opts in (None, {"explain": True}, {"max_nodes": 5, "explain": True}):
        assert _engine_token(opts) == _jtoken(opts)


# -- certificate chains + replay ----------------------------------------------

@pytest.mark.parametrize("case", ["tp_layer", "fsdp_mlp", "sp_moe",
                                  "tp_dp_2d", "grad_accum"])
def test_chain_replays_outside_egraph(case):
    expl = _expl(case)
    assert expl["kind"] == "certificate"
    assert expl["total_steps"] >= 1
    assert expl["total_steps"] == _jexpl(case)["total_steps"]
    res = check_explanation(expl, **CPU)
    assert res["ok"], res["failures"]
    assert res["checked_steps"] >= expl["total_steps"]


def test_replay_rejects_tampered_step():
    expl = json.loads(json.dumps(_expl("tp_layer")))
    (out,) = [o for o in expl["outputs"].values() if o["steps"]][:1]
    step = out["steps"][0]
    step["rhs"]["op"] = "add" if step["rhs"]["op"] != "add" else "mul"
    res = check_explanation(expl, **CPU)
    assert not res["ok"]
    assert res["failures"]


def test_chain_deterministic_across_opt_modes():
    saved = CONFIG.as_dict()
    try:
        set_optimizations(True)
        on = _expl("tp_dp_2d")
        set_optimizations(False)
        off = _expl("tp_dp_2d")
    finally:
        set_optimizations(True, **saved)
    assert _dump(on) == _dump(off)


_PROG = ("import json, sys; sys.path.insert(0, 'src'); "
         "from repro_torch.api import verify; "
         "print(json.dumps(verify('tp_dp_2d', device='cpu', "
         "engine_opts={'explain': True}).explanation, sort_keys=True))")


def test_chain_deterministic_across_hash_seeds():
    """Member sets iterate in hash order and the engine sorts them
    structurally, so the chain survives hash randomization. The seed is
    fixed per process: two fresh interpreters, run side by side."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROG], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONHASHSEED=seed)) for seed in ("1", "2")]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs[0] and outs[0] == outs[1]
    assert json.loads(outs[0]) == json.loads(_dump(_jexpl("tp_dp_2d")))


def test_chain_deterministic_across_worker_counts():
    r1 = check_model("gpt", "dp2", workers=0, engine_opts={"explain": True},
                     **CPU)
    r2 = check_model("gpt", "dp2", workers=2, engine_opts={"explain": True},
                     **CPU)
    assert r1.verdict == r2.verdict == "certificate"
    assert _dump(r1.explanation) == _dump(r2.explanation)
    for key in r1.reports:
        assert _dump(r1.reports[key].get("explanation")) == \
            _dump(r2.reports[key].get("explanation"))


# -- failure frontier ---------------------------------------------------------

def test_failure_frontier_names_stuck_op():
    rep = verify("sp_rope", bug="rope_offset", engine_opts={"explain": True},
                 **CPU)
    assert rep.verdict == "refinement_error"
    expl = rep.explanation
    assert expl is not None and expl["kind"] == "failure_frontier"
    assert expl["stuck_op"]["op_name"]
    narrative = "\n".join(expl["narrative"])
    assert "stuck at" in narrative
    assert "lemma" in narrative
    assert render_narrative(expl) == expl["narrative"]
    jexpl = jverify("sp_rope", bug="rope_offset",
                    engine_opts={"explain": True}).explanation
    assert expl["stuck_op"] == jexpl["stuck_op"]


def test_failure_frontier_in_family_report():
    rep = check_train("dp_accum", bug="accum_no_rescale",
                      engine_opts={"explain": True}, **CPU)
    assert rep.ok
    frontiers = [r.get("explanation") for r in rep.reports.values()
                 if (r.get("explanation") or {}).get("kind")
                 == "failure_frontier"]
    assert len(frontiers) == 1
    assert frontiers[0]["stuck_op"]["op_name"]


# -- aggregation --------------------------------------------------------------

def test_aggregate_explanations_rolls_up():
    rep = check_serve("tp_decode", engine_opts={"explain": True}, **CPU)
    agg = rep.explanation
    assert agg is not None and agg["kind"] == "summary"
    assert agg["total_steps"] == sum(
        explanation_steps(r.get("explanation"))
        for r in rep.reports.values())
    assert set(agg["per_obligation"]) == set(rep.reports)
    assert aggregate_explanations({"a": {}, "b": {"x": 1}}) is None
    assert render_narrative(agg)[-1].startswith("total chain steps:")


# -- CLI envelope -------------------------------------------------------------

def test_cli_envelope_explanation_key(capsys):
    with pytest.raises(SystemExit):
        verify_main(["--case", "sp_rope", "--bug", "rope_offset",
                     "--explain", "--json", "--device", "cpu"])
    env = json.loads(capsys.readouterr().out)
    assert "explanation" in env
    assert env["explanation"]["kind"] == "failure_frontier"
    assert "explanation" not in env["report"]


def test_cli_envelope_without_explain_flag(capsys):
    verify_main(["--case", "tp_layer", "--json", "--device", "cpu"])
    env = json.loads(capsys.readouterr().out)
    assert "explanation" not in env
    assert "explanation" not in env["report"]


# -- obs: gzip traces + json report -------------------------------------------

def test_trace_gzip_roundtrip(tmp_path):
    tracer = obs_trace.Tracer("test")
    with tracer.span("outer", cat="engine", k=1):
        tracer.event("explain", cat="engine", outputs=2, steps=5)
    chrome = str(tmp_path / "t.json.gz")
    jsonl = str(tmp_path / "t.jsonl.gz")
    tracer.write_chrome(chrome)
    tracer.write_jsonl(jsonl)
    with gzip.open(chrome, "rt") as f:
        assert "traceEvents" in json.load(f)
    evs = obs_trace.load_events(chrome)
    assert any(e.get("name") == "explain" for e in evs)
    evs2 = obs_trace.load_events(jsonl)
    assert any(e.get("name") == "outer" for e in evs2)


def test_obs_report_json_stable(tmp_path, capsys):
    from repro.obs.inspect import to_json_report as jto_json_report
    tracer = obs_trace.Tracer("test")
    tracer.event("explain", cat="engine", outputs=1, steps=3)
    with tracer.span("explain.build", cat="engine"):
        pass
    path = str(tmp_path / "t.jsonl")
    tracer.write_jsonl(path)
    rc = report(path, as_json=True)
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["explanations"]["steps"] == 3
    assert out["explanations"]["explanations"] == 1
    evs = obs_trace.load_events(path)
    assert json.dumps(to_json_report(evs), sort_keys=True) \
        == json.dumps(to_json_report(evs), sort_keys=True)
    assert to_json_report(evs)["explanations"] == \
        jto_json_report(evs)["explanations"]


def test_cli_trace_gz_sibling(tmp_path, capsys):
    path = str(tmp_path / "run.json.gz")
    verify_main(["--case", "tp_layer", "--json", "--trace", path,
                 "--device", "cpu"])
    capsys.readouterr()
    assert os.path.exists(path)
    assert os.path.exists(str(tmp_path / "run.jsonl.gz"))

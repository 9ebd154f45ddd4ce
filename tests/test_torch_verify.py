"""The port's verify CLI and API on the CPU (``--device cpu``), and the
rule that no module of the port imports JAX or the JAX package."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import api as tapi
from repro_torch.launch import verify as cli
from repro_torch import quickstart
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
NEW_MODULES = [
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.core", "repro_torch.core.terms", "repro_torch.core.symbolic",
    "repro_torch.core.profile", "repro_torch.core.egraph",
    "repro_torch.core.lemmas", "repro_torch.core.explain",
    "repro_torch.core.infer", "repro_torch.core.spmd",
    "repro_torch.core.capture", "repro_torch.core.from_fx",
    "repro_torch.core.convert", "repro_torch.api", "repro_torch.api.spec",
    "repro_torch.api.report", "repro_torch.api.registry",
    "repro_torch.api.runner", "repro_torch.api.replay", "repro_torch.dist",
    "repro_torch.dist.strategies", "repro_torch.launch",
    "repro_torch.launch.verify", "repro_torch.quickstart",
    "repro_torch.obs.inspect", "repro_torch.runtime",
    "repro_torch.runtime.cache", "repro_torch.runtime.chaos",
    "repro_torch.runtime.pool", "repro_torch.api.suite",
    "repro_torch.api.functions", "repro_torch.verify_your_own_fn",
    "repro_torch.sharding", "repro_torch.sharding.specs",
    "repro_torch.modelcheck", "repro_torch.modelcheck.obligations",
    "repro_torch.modelcheck.blocks", "repro_torch.modelcheck.decompose",
    "repro_torch.modelcheck.report", "repro_torch.modelcheck.stitch",
    "repro_torch.modelcheck.schedule", "repro_torch.gradcheck",
    "repro_torch.gradcheck.capture_grad", "repro_torch.gradcheck.transpose",
    "repro_torch.gradcheck.obligations", "repro_torch.gradcheck.report",
    "repro_torch.gradcheck.schedule", "repro_torch.servecheck",
    "repro_torch.servecheck.relations", "repro_torch.servecheck.obligations",
    "repro_torch.servecheck.report", "repro_torch.servecheck.schedule",
    "repro_torch.launch.explain_smoke", "repro_torch.launch.train",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.train", "repro_torch.train.loop",
    "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
    "repro_torch.checkpoint._msgpack",
]


def _main(capsys, *argv):
    code = 0
    try:
        cli.main(list(argv))
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_list(capsys):
    code, out = _main(capsys, "--list")
    assert code == 0
    for name in tapi.list_strategies():
        assert f"[case]  {name}" in out
    assert "rope_offset            -> sp_rope" in out


def test_json_clean_case_exits_0(capsys):
    code, out = _main(capsys, "--case", "tp_layer", "--json",
                      "--device", "cpu")
    assert code in (0, None)
    env = json.loads(out)
    assert sorted(env) == ["kind", "report", "schema_version", "timing"]
    assert env["schema_version"] == 2 and env["kind"] == "case"
    rep = env["report"]
    assert rep["verdict"] == "certificate" and rep["ok"]
    assert rep["r_o"] == {"t2": "t3@tp0"}
    assert set(env["timing"]) == {"wall_s", "infer_s", "phase_s"}


def test_json_bug_exits_1(capsys):
    code, out = _main(capsys, "--case", "sp_rope", "--bug", "rope_offset",
                      "--json", "--device", "cpu")
    assert code == 1
    rep = json.loads(out)["report"]
    assert rep["verdict"] == "refinement_error" and rep["ok"]
    assert {k: rep["localization"][k] for k in
            ("op_index", "op_name", "out_name")} == \
        {"op_index": 2, "op_name": "mul", "out_name": "t2"}


def test_text_paths(capsys):
    code, out = _main(capsys, "--case", "tp_dp_2d", "--degree", "4x2",
                      "--device", "cpu")
    assert code in (0, None) and "REFINEMENT HOLDS" in out
    code, out = _main(capsys, "--case", "sp_rope", "--bug", "rope_offset",
                      "--device", "cpu")
    assert code == 1
    assert "REFINEMENT FAILED" in out and "operator #2 `mul`" in out


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--case", "tp_layer"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.verify("tp_layer")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.verify("tp_layer", device="cuda")


def test_wrong_host_bug_raises():
    with pytest.raises(ValueError, match="belongs to case"):
        tapi.verify("tp_layer", bug="rope_offset", device="cpu")


def test_serve_task_kind_runs(capsys):
    """The serving path runs: its task list, its runner and its CLI flag,
    clean and with a localized bug (exit 1)."""
    assert tapi.list_serve_tasks() == ("serve@tp_decode", "serve@sp_cache",
                                       "serve@batched_decode")
    report = tapi.check_serve_task("serve@batched_decode", device="cpu")
    assert report.ok and (report.total_steps,
                          report.unique_obligations) == (5, 5)
    assert report.task_id() == "serve@batched_decode@deg2x2"
    with pytest.raises(KeyError, match="bad serve task"):
        tapi.check_serve_task("tp_decode")
    code, out = _main(capsys, "--serve", "tp_decode", "--device", "cpu")
    assert code == 0 and "SERVING-PATH REFINEMENT HOLDS" in out
    code, out = _main(capsys, "--serve", "tp_decode", "--inject-bug",
                      "stale_cache_shard", "--device", "cpu")
    assert code == 1 and "failing steps ['step3']" in out


def test_model_and_train_task_kinds_run(capsys):
    """The model and train-step paths (ROADMAP items 6-7) run: their task
    lists, their runners and their CLI flags."""
    assert "gpt@dp2xtp2" in tapi.list_model_tasks()
    assert "train@dp_accum" in tapi.list_train_tasks()
    report = tapi.check_model_task("gpt@dp2xtp2", device="cpu")
    assert report.ok and (report.total_blocks,
                          report.unique_obligations) == (14, 3)
    report = tapi.check_train_task("train@dp", device="cpu")
    assert report.ok and report.verdict == "certificate"
    code, out = _main(capsys, "--model", "gpt", "--device", "cpu")
    assert code == 0 and "WHOLE-MODEL REFINEMENT HOLDS" in out
    code, out = _main(capsys, "--train", "dp", "--device", "cpu")
    assert code == 0 and "TRAIN-STEP REFINEMENT HOLDS" in out


def test_quickstart(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "TP layer verified" in out and "#3 `matmul`" in out


def test_cli_runs_as_a_module():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.verify", "--case",
         "ln_grad", "--bug", "ln_no_allreduce", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr
    assert "t1 = add(t1@sp0, t1@sp1)" in r.stdout


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {NEW_MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_import_line_names_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert not bad, bad
    listed = {m.replace(".", os.sep) for m in NEW_MODULES}
    found = {os.path.relpath(f, SRC)[:-3].removesuffix(os.sep + "__init__")
             for f in files[1:]}
    assert listed <= found

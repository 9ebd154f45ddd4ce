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


def test_unported_task_kinds_name_their_roadmap_items():
    """Only the model, train-step and serving paths are still unported
    (ROADMAP items 6-8): their task lists and their CLI flags raise."""
    for fn, item in ((tapi.list_model_tasks, 6), (tapi.list_train_tasks, 7),
                     (tapi.list_serve_tasks, 8),
                     (lambda: cli.main(["--model", "gpt"]), 6),
                     (lambda: cli.main(["--train", "dp"]), 7),
                     (lambda: cli.main(["--serve", "tp_decode"]), 8)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()


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

"""The port's user-facing drivers against the JAX package, on the CPU.

* ``verify_bug_suite``: each bug's verdict, ``op_name`` and ``op_index``
  are those of the JAX package's ``Suite(...).run(workers=0)`` over the
  same tasks, and each line is the JAX example's;
* ``serve_decode`` on the reduced gemma3-12b in fp32, JAX's
  ``init_params(PRNGKey(0))`` carried over by ``convert.from_jax``, one
  prompt (a numpy array from a seed) fed to both: the generated tokens
  equal JAX's ``decode_tokens``, the prefill logits within 2e-4 relative
  of JAX's ``sequential_prefill``;
* ``train_gpt_100m.train`` on the reduced gpt (fp32), 3 steps of its
  ``TrainConfig`` (``microbatches=2``) on the same ``SyntheticTextDataset``
  batches: each step's loss within 1e-5 and gradient norm within 1e-4
  (relative) of JAX's ``make_train_step`` with the same config;
* the golden regenerator (``python -m repro_torch.api --update-golden``):
  the file it writes passes ``--check``, and it refuses the JAX
  package's golden, a failing matrix and the matrix flags;
* ``python -m repro_torch.launch.ci --list``, and each driver's refusal
  to fall back to the CPU without ``--device cpu``.
"""
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Suite as JSuite
from repro.api import list_bugs as jlist_bugs
from repro.data.pipeline import SyntheticTextDataset as JDataset
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import serve as jserve
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch import serve_decode as sd
from repro_torch import train_gpt_100m as tg
from repro_torch import verify_bug_suite as vbs
from repro_torch.api import Report
from repro_torch.api import suite as suite_mod
from repro_torch.launch import ci
from repro_torch.models import convert, registry

SERVE_REL = 2e-4
LOSS_REL, GNORM_REL = 1e-5, 1e-4
GOLDEN = "tests/golden/suite_degree2.json"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _port_model(arch):
    """(jax cfg, jax params, the port's model holding them on the CPU)."""
    jcfg = jregistry.load_config(arch).reduced()
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.from_jax(jax.tree.map(np.asarray, jparams),
                             registry.load_config(arch).reduced(),
                             device="cpu")
    return jcfg, jparams, model


def test_bug_suite_as_jax():
    bugs = jlist_bugs()
    want = JSuite(cases=sorted({h for h, _ in bugs.values()}), degrees=(2,),
                  bugs=sorted(bugs)).run(workers=0)
    got = vbs.run_bug_suite("cpu")
    assert got.ok and want.ok
    assert [r.task_id() for r in got] == [r.task_id() for r in want]
    for g, w in zip(got, want):
        assert g.verdict == w.verdict, g.task_id()
        if w.localization is not None:
            assert {k: g.localization[k] for k in ("op_name", "op_index")} \
                == {k: w.localization[k] for k in ("op_name", "op_index")}, \
                g.task_id()
        if g.bug is not None and g.verdict == "refinement_error":
            assert vbs.status(g) == (
                f"bug {w.bug:16s} -> detected: "
                f"{w.localization['op_name']} at G_s op "
                f"#{w.localization['op_index']}")
    out = io.StringIO()
    with redirect_stdout(out):
        assert vbs.main(["--device", "cpu"]) == 0
    assert len(out.getvalue().splitlines()) == len(bugs)


def test_serve_decode_as_jax():
    jcfg, jparams, model = _port_model("gemma3-12b")
    B, S, gen, max_seq = 4, 12, 16, 64
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    got = sd.serve_decode(model, torch.from_numpy(prompt), gen, max_seq)
    jcache, jlogits = jserve.sequential_prefill(
        jparams, jcfg, jnp.asarray(prompt, jnp.int32), max_seq)
    last = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    _, jtoks = jserve.decode_tokens(jparams, jcfg, jcache, last, S, gen)
    assert _rel(got["logits"].numpy(), np.asarray(jlogits)) <= SERVE_REL
    assert got["tokens"].tolist() == np.asarray(jtoks).tolist()
    assert tuple(got["tokens"].shape) == (B, gen)


def test_train_gpt_100m_as_jax():
    jcfg, jparams, model = _port_model("gpt")
    steps, batch, seq = 3, 8, 32
    got = tg.train(model, steps, batch, seq, log_every=0)
    jtcfg = JTrainConfig(optimizer=JAdamWConfig(lr=1e-3, warmup_steps=20),
                         microbatches=2)
    assert tg.TRAIN_CONFIG.microbatches == jtcfg.microbatches
    step = jax.jit(jmake_train_step(jcfg, jtcfg))
    ds = JDataset(vocab=jcfg.vocab, seq_len=seq, batch=batch, seed=0)
    params, opt = jparams, jadamw.init(jparams)
    for i in range(steps):
        params, opt, m = step(params, opt, ds.batch_at(i))
        assert _rel(got["losses"][i], m["loss"]) <= LOSS_REL, i
        assert _rel(got["grad_norms"][i], m["grad_norm"]) <= GNORM_REL, i
    assert got["first"] == got["losses"][0]
    assert got["last"] == got["losses"][-1]


def test_train_gpt_100m_writes_its_checkpoint(tmp_path):
    model = registry.init_params(registry.load_config("gpt").reduced(), 0,
                                 "cpu")
    got = tg.train(model, 1, 2, 16, ckpt=str(tmp_path), log_every=0)
    assert len(got["losses"]) == 1 and any(tmp_path.iterdir())


def test_update_golden_passes_check(tmp_path, capsys):
    path = str(tmp_path / "golden.json")
    assert suite_mod.main(["--device", "cpu", "--workers", "0",
                           "--update-golden", path]) == 0
    written = json.loads(open(path).read())
    assert not any(suite_mod.golden_mismatches(
        written, json.loads(open(GOLDEN).read())).values())
    assert suite_mod.main(["--device", "cpu", "--workers", "0",
                           "--degrees", "2", "--check", path]) == 0
    assert "matches golden" in capsys.readouterr().err


def test_update_golden_refuses_the_reference(capsys):
    assert suite_mod.update_golden(GOLDEN, workers=0, device="cpu") == 2
    assert "REFUSING" in capsys.readouterr().err


def test_update_golden_refuses_a_failing_matrix(tmp_path, monkeypatch,
                                                capsys):
    def failing(case, degree=2, bug=None, engine_opts=None, device=None):
        return Report(case=case, degree=degree, bug=bug, verdict="error",
                      expected="certificate", ok=False, error="synthetic")
    monkeypatch.setattr(suite_mod, "verify", failing)
    path = tmp_path / "golden.json"
    assert suite_mod.update_golden(str(path), workers=0, device="cpu") == 1
    assert not path.exists()
    assert "REFUSING" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--bugs"], ["--cases", "tp_layer"],
                                  ["--check", GOLDEN], ["--no-cache"],
                                  ["--write-golden", "x.json"]])
def test_update_golden_refuses_matrix_flags(flag, tmp_path):
    with pytest.raises(SystemExit) as e:
        suite_mod.main(["--update-golden", str(tmp_path / "g.json")] + flag)
    assert e.value.code == 2


def test_ci_lists_every_target(capsys):
    assert ci.main(["--list"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.splitlines()]
    assert listed == [
        "verify", "quick", "bug-suite", "suite", "golden",
        "modelcheck-smoke", "gradcheck-smoke", "servecheck-smoke",
        "chaos-smoke", "cache-smoke", "fn-smoke", "obs-smoke",
        "explain-smoke", "docs-check", "bench-smoke", "bench-gate"]
    assert ci.main(["bench-gate"]) == 2
    assert ci.main(["no-such-target"]) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU's "
                    "refusal to stand in for a missing card")
@pytest.mark.parametrize("main", [vbs.main, sd.main, tg.main],
                         ids=["verify_bug_suite", "serve_decode",
                              "train_gpt_100m"])
def test_drivers_need_a_card_or_device_cpu(main):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced"] if main is tg.main else [])

"""repro_torch.servecheck on the runtime, numerically, and from the CLI.

On the CPU, against the JAX package where it has the same thing:

* the spawned pool gives the in-process report byte for byte (timings
  and the worker count aside), and a warm certificate cache replays
  every verdict;
* the fragments compute what the JAX fragments compute: the same numpy
  inputs through each ``seq_fn`` and, per rank, the expanded G_d agree
  within 1e-5 of the output's scale (float32), and each clean
  certificate replays within rtol = atol = 2e-4;
* ``--serve``: the JAX CLI's ``--json`` envelope (timings aside), its exit
  codes and its "SERVING-PATH REFINEMENT HOLDS";
* the engine fingerprint hashes ``servecheck`` and ``optim``;
* ``python -m repro_torch.launch.explain_smoke --device cpu`` passes its
  three legs.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capture_spmd as jcapture_spmd
from repro.core import expand_spmd as jexpand
from repro.core.terms import eval_term as jeval
from repro.servecheck import get_serve_strategy as jget_serve_strategy

from repro_torch.api.replay import max_rel_excess, replay
from repro_torch.core import capture_spmd, expand_spmd
from repro_torch.core.terms import eval_term
from repro_torch.launch import explain_smoke
from repro_torch.launch.verify import main as verify_main
from repro_torch.runtime import cache as cache_mod
from repro_torch.runtime.cache import engine_fingerprint
from repro_torch.servecheck import check_serve, get_serve_strategy
from torch_parity import close_to_scale, run, shard, stable_report_json
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
NUMERIC = [("tp_decode", 2), ("batched_decode", (2, 2))]


# ---------------------------------------------------------------------------
# the runtime: pool and cache
# ---------------------------------------------------------------------------

def test_identical_reports_across_worker_counts():
    inproc = check_serve("batched_decode", workers=1, **CPU)
    pooled = check_serve("batched_decode", workers=2, **CPU)
    assert (inproc.workers, pooled.workers) == (1, 2)
    assert not any((r.get("runtime") or {}).get("degraded_reason")
                   for r in pooled.reports.values())
    assert json.dumps(pooled.stable_summary(), sort_keys=True) == \
        json.dumps(inproc.stable_summary(), sort_keys=True)
    assert stable_report_json(pooled) == stable_report_json(inproc)


def test_warm_cache_replays_every_verdict(tmp_path):
    cold = check_serve("tp_decode", bug="stale_cache_shard", cache=tmp_path,
                       **CPU)
    warm = check_serve("tp_decode", bug="stale_cache_shard", cache=tmp_path,
                       **CPU)
    assert (cold.cache["hits"], cold.cache["misses"]) == (0, 5)
    assert (warm.cache["hits"], warm.cache["misses"]) == (5, 0)
    assert warm.ok and warm.failing_steps == ["step3"]
    assert warm.stable_summary() == cold.stable_summary()
    for key in cold.reports:
        a, b = dict(cold.reports[key]), dict(warm.reports[key])
        a.pop("runtime", None)
        b.pop("runtime", None)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_fingerprint_hashes_servecheck_and_optim(tmp_path, monkeypatch):
    """Editing a file under servecheck/ or optim/ (in a copy of the
    package) changes the engine fingerprint."""
    src = os.path.join(ROOT, "src", "repro_torch")
    pkg = tmp_path / "repro_torch"
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    # the fingerprint hashes the package its module file sits in
    monkeypatch.setattr(cache_mod, "__file__",
                        str(pkg / "runtime" / "cache.py"))
    fingerprints = []
    for rel in (None, ("servecheck", "obligations.py"),
                ("optim", "adamw.py")):
        if rel is not None:
            f = pkg.joinpath(*rel)
            f.write_text(f.read_text() + "\n# edited\n")
        engine_fingerprint.cache_clear()
        fingerprints.append(engine_fingerprint())
    assert len(set(fingerprints)) == 3
    monkeypatch.undo()
    engine_fingerprint.cache_clear()


# ---------------------------------------------------------------------------
# numeric parity and replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,degree", NUMERIC)
def test_fragments_compute_as_jax(strategy, degree):
    """Each obligation's seq_fn, and per rank its expanded G_d, in both
    packages on the same numpy inputs: within 1e-5 of the output's scale
    in float32."""
    mine = get_serve_strategy(strategy).build(degree=degree)
    ref = jget_serve_strategy(strategy).build(degree=degree)
    rng = np.random.default_rng(0)
    for key in mine.keys_in_order():
        m, r = mine.unique[key], ref.unique[key]
        values = {n: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                  for n, (shape, _) in zip(m.input_names, m.avals)}
        want = r.seq_fn(*(jnp.asarray(values[n]) for n in r.input_names))
        got = m.seq_fn(*(torch.from_numpy(values[n])
                         for n in m.input_names))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close_to_scale(g.numpy(), np.asarray(w))
        jgd, _ = jexpand(jcapture_spmd(r.dist_fn, dict(r.mesh_axes),
                                       list(r.in_specs), list(r.avals),
                                       list(r.input_names)))
        gd, _ = expand_spmd(capture_spmd(
            m.dist_fn, dict(m.mesh_axes), list(m.in_specs), list(m.avals),
            list(m.input_names), **CPU))
        shards = shard(values, r.input_names, r.in_specs, dict(r.mesh_axes))
        gw = run(jgd, shards, jeval)
        gt = run(gd, {k: torch.from_numpy(v) for k, v in shards.items()},
                 eval_term)
        assert list(gt) == list(gw), key
        for o in gw:
            close_to_scale(gt[o], gw[o])


@pytest.mark.parametrize("strategy,degree", NUMERIC)
def test_certificates_replay(strategy, degree):
    obset = get_serve_strategy(strategy).build(degree=degree)
    for key in obset.keys_in_order():
        got, want = replay(obset.unique[key].to_strategy_spec(name=key),
                           "cpu")
        assert set(got) == set(want) and got
        assert max_rel_excess(got, want) <= 1.0, key


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _envelope(capsys, main, argv):
    try:
        main(argv)
    except SystemExit as e:               # bug paths exit(1) by design
        assert e.code in (None, 0, 1)
    return json.loads(capsys.readouterr().out)


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
    return json.dumps(env, sort_keys=True)


@pytest.mark.parametrize("argv", [
    ["--serve", "batched_decode", "--degree", "2x2", "--json"],
    ["--serve", "batched_decode", "--inject-bug", "cache_gather_wrong_axis",
     "--json"]], ids=["clean", "cache_gather_wrong_axis"])
def test_serve_envelope_matches_jax(capsys, argv):
    from repro.launch.verify import main as jmain
    env = _envelope(capsys, verify_main, argv + ["--device", "cpu"])
    jenv = _envelope(capsys, jmain, argv)
    assert env["schema_version"] == 2
    assert env["kind"] == jenv["kind"] == "serve"
    assert set(env) == {"schema_version", "kind", "timing", "report"}
    assert set(env["report"]) == set(jenv["report"])
    assert _stable_envelope(env) == _stable_envelope(jenv)


def test_cli_serve_exit_codes(capsys):
    verify_main(["--serve", "batched_decode", "--degree", "2x2",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "SERVING-PATH REFINEMENT HOLDS (5 serving blocks proved by 5 " \
        "obligations" in out
    with pytest.raises(SystemExit) as e:
        verify_main(["--serve", "batched_decode", "--inject-bug",
                     "cache_gather_wrong_axis", "--device", "cpu"])
    assert e.value.code == 1
    assert "SERVING-PATH VERDICT: unexpected_relation — failing steps " \
        "['step1']" in capsys.readouterr().out
    for argv in (["--inject-bug", "wrong_spec"],          # a model bug
                 ["--inject-bug", "accum_no_rescale"],    # a gradient bug
                 ["--bug-layer", "3"],
                 ["--case", "tp_layer"]):
        with pytest.raises(SystemExit) as e:
            verify_main(["--serve", "tp_decode", "--device", "cpu"] + argv)
        assert e.value.code == 2, argv
    with pytest.raises(SystemExit) as e:       # a wrong degree: exit 2
        verify_main(["--serve", "batched_decode", "--degree", "2x4",
                     "--inject-bug", "cache_gather_wrong_axis",
                     "--device", "cpu"])
    assert e.value.code == 2
    assert "square mesh" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:       # a serve bug under --model
        verify_main(["--model", "gpt", "--inject-bug", "stale_cache_shard",
                     "--device", "cpu"])
    assert e.value.code == 2


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_serve("tp_decode")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_main(["--serve", "tp_decode"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        explain_smoke.run()


# ---------------------------------------------------------------------------
# the explain smoke
# ---------------------------------------------------------------------------

def test_explain_smoke_passes_on_the_cpu(capsys):
    assert explain_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[explain-smoke] all legs passed" in out
    assert "bug serve stale_cache_shard: frontier names stuck op " \
        "`output-filter` (#5): ok" in out
    assert "FAIL" not in out

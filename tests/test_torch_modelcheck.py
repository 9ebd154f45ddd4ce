"""repro_torch.modelcheck against repro.modelcheck: whole-model checks.

Mirrors tests/test_modelcheck.py on the port (decomposition, the dedup
cache, seams, whole-model certificates, bug localization, the pool, the
registry and the CLI), on the CPU, and holds it against the JAX package:

* plans: ``spec_for`` gives the same tuples for every logical-axes tuple
  the blocks use, under every default plan and ``tp4``;
* decomposition: the same block list and canonical keys (the same
  strings) for every model x plan, and the same errors;
* engine parity: each unique obligation captured by the JAX package and
  carried across runs through the port's engine with the JAX engine's
  verdict, ``pretty(R_o)``, localization, lemma fires and explanation
  steps; summed over a task they are ``BENCH_verify.json``'s;
* capture parity: the port's own ``check_model`` gives the JAX report's
  stable summary, R_o strings and fires;
* numeric parity: the same numpy inputs through each block's ``seq_fn``
  and, per rank, its expanded G_d agree within 1e-5 of the output's scale
  (float32), and each clean certificate replays within the replay
  tolerance (rtol = atol = 2e-4), inputs at a model's scale for both.
"""
import dataclasses
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import capture as jcapture, capture_spmd as jcapture_spmd
from repro.core import check_refinement as jcheck, expand_spmd as jexpand
from repro.core import RefinementError as JRefinementError
from repro.core import terms as JT
from repro.core.terms import eval_term as jeval
from repro.modelcheck import check_model as jcheck_model
from repro.modelcheck import decompose as jdecompose
from repro.modelcheck import supported_models as jsupported_models
from repro.sharding import specs as jspecs

from repro_torch.api import check_model_task, list_model_tasks
from repro_torch.api.replay import SCALE as REPLAY_SCALE, \
    SEED as REPLAY_SEED, max_rel_excess, replay, shard_inputs
from repro_torch.api.runner import capture_task
from repro_torch.core import (RefinementError, capture_chain,
                              capture_spmd, check_refinement, expand_spmd)
from repro_torch.core import terms as PT
from repro_torch.core.terms import eval_term
from repro_torch.launch.verify import main as verify_main
from repro_torch.models.registry import load_config
from repro_torch.modelcheck import (ModelCheckError, ModelReport,
                                    check_model, decompose,
                                    expected_output_relation,
                                    supported_models)
from repro_torch.modelcheck.blocks import layer_obligation, replay_inputs
from repro_torch.runtime import cache as cache_mod
from repro_torch.runtime.cache import engine_fingerprint
from repro_torch.sharding.specs import (DEFAULT_PLANS, default_rules,
                                        parse_plan)
from torch_parity import carried, close_to_scale, outcome, run, shard
from torch_parity import one_thread_module  # noqa: F401 (one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCH_verify.json")))
CPU = {"device": "cpu"}
PLANS = DEFAULT_PLANS + ("tp4",)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def test_parse_plan():
    plan = parse_plan("dp2xtp2")
    assert plan.mesh_axes == {"dp": 2, "tp": 2}
    assert plan.degree == (2, 2)
    assert parse_plan("dp4").mesh_axes == {"dp": 4}
    for bad in ("dp1", "zz2", "dp2xdp2"):
        with pytest.raises(ValueError):
            parse_plan(bad)
        with pytest.raises(ValueError):
            jspecs.parse_plan(bad)
    assert DEFAULT_PLANS == jspecs.DEFAULT_PLANS
    assert parse_plan("tp2xdp4").axes == jspecs.parse_plan("tp2xdp4").axes


def test_plan_rules_drive_specs():
    plan = parse_plan("dp2xtp2")
    assert tuple(plan.spec_for(("batch", "seq", "embed"))) == \
        ("dp", None, None)
    assert tuple(plan.spec_for(("embed", "heads"))) == (None, "tp")
    # a dp-only plan leaves tensor dims unsharded
    assert set(parse_plan("dp2").spec_for(("embed", "heads"))) <= {None}


# every logical-axes tuple the block programs and the production rules use
LOGICAL = sorted({
    ("batch", "seq"), ("vocab_rows", "embed_tp"), ("batch", "seq", "embed"),
    ("embed",), ("embed", "heads"), ("embed", "kv_heads"),
    ("heads", "embed"), ("embed", "ff"), ("ff", "embed"),
    ("experts", "embed", "expert_ff"), ("experts", "expert_ff", "embed"),
    ("embed", "vocab"), ("batch", "seq", "vocab"), (None, "embed"),
    ("layers", "embed_fsdp", "qheads"), ("act_ff", "act_heads", "state"),
    ("kv_seq", "conv", "expert_fsdp")}, key=str)


@pytest.mark.parametrize("plan", PLANS)
def test_spec_for_matches_jax(plan):
    mine, ref = parse_plan(plan), jspecs.parse_plan(plan)
    assert mine.rules.rules == ref.rules.rules
    for axes in LOGICAL:
        assert tuple(mine.spec_for(axes)) == tuple(ref.spec_for(axes)), axes
    for multi_pod, fsdp in itertools.product((False, True), repeat=2):
        a = default_rules(multi_pod, fsdp)
        b = jspecs.default_rules(multi_pod, fsdp)
        assert a.rules == b.rules
        for axes in LOGICAL:
            assert tuple(a.spec_for(axes)) == tuple(b.spec_for(axes))


# ---------------------------------------------------------------------------
# decomposition + dedup
# ---------------------------------------------------------------------------

def test_decompose_gpt_block_structure():
    dec = decompose("gpt", "dp2xtp2", **CPU)
    names = [n for n, _ in dec.obset.blocks]
    assert names[0] == "embed" and names[-1] == "head"
    assert len(names) == load_config("gpt").n_layers + 2
    # 12 identical layers + embed + head -> exactly 3 unique obligations
    assert dec.n_unique == 3
    assert dec.dedup_ratio == pytest.approx(14 / 3)


def test_dedup_is_layer_count_invariant():
    cfg = load_config("gpt")
    small = dataclasses.replace(cfg, n_layers=2)
    big = dataclasses.replace(cfg, n_layers=9)
    k_small = set(decompose(small, "dp2xtp2", **CPU).obset.unique)
    k_big = set(decompose(big, "dp2xtp2", **CPU).obset.unique)
    assert k_small == k_big
    assert decompose(big, "dp2xtp2", **CPU).total_blocks == 11


def test_pattern_roles_split_obligations():
    dec = decompose("gemma3-12b", "dp2", **CPU)
    kinds = {}
    for _, key in dec.obset.blocks:
        kinds[key] = kinds.get(key, 0) + 1
    layer_keys = [k for k in kinds if k.startswith("block-")]
    assert len(layer_keys) == 2          # local + global
    n = load_config("gemma3-12b").n_layers
    assert sorted(kinds[k] for k in layer_keys) == [n // 6, 5 * n // 6]


def test_bug_splits_dedup_class():
    dec = decompose("gpt", "dp2xtp2", bug="wrong_spec", bug_layer=3, **CPU)
    assert dec.n_unique == 4             # embed, clean layer, bug layer, head
    _, bug_key = dec.obset.blocks[4]     # block 4 == layer3
    assert dec.obset.block_indices(bug_key) == [4]


def test_unsupported_family_raises():
    with pytest.raises(ModelCheckError, match="unknown model"):
        decompose("nope", "dp2", **CPU)
    with pytest.raises(ModelCheckError, match="bug_layer"):
        decompose("gpt", "dp2", bug="wrong_spec", bug_layer=99, **CPU)


@pytest.mark.parametrize("model,family,why_fragment", [
    ("mamba2-1.3b", "ssm", "cumsum lemma"),
    ("recurrentgemma-2b", "hybrid", "RG-LRU"),
    ("whisper-medium", "audio", "encoder-decoder"),
])
def test_unsupported_family_error_is_the_references(model, family,
                                                    why_fragment):
    with pytest.raises(ModelCheckError) as ei:
        decompose(model, "dp2", **CPU)
    msg = str(ei.value)
    assert f"family `{family}`" in msg and why_fragment in msg
    assert "supported families: ['dense', 'moe', 'vlm']" in msg
    for mid in supported_models():
        assert mid in msg
    with pytest.raises(ValueError) as ej:
        jdecompose(model, "dp2")
    assert msg == str(ej.value)
    with pytest.raises(ModelCheckError, match=f"family `{family}`"):
        check_model(model, "dp2xtp2", **CPU)


def test_obligation_key_ignores_fn_identity():
    cfg, plan = load_config("gpt"), parse_plan("dp2xtp2")
    a = layer_obligation(cfg, plan, **CPU)
    b = layer_obligation(cfg, plan, **CPU)
    assert a.seq_fn is not b.seq_fn and a.key == b.key
    assert layer_obligation(cfg, plan, role="local", **CPU).key != a.key


def _decomposition(decompose_fn, model, plan, **kw):
    try:
        dec = decompose_fn(model, plan, **kw)
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return dec.obset.blocks


@pytest.mark.parametrize("plan", PLANS)
def test_blocks_and_canonical_keys_match_jax(plan):
    """The same (block, canonical key) list — the keys as strings — for
    every supported model, and the same refusal where a plan does not
    divide a model."""
    assert supported_models() == jsupported_models()
    for model in supported_models():
        mine = _decomposition(decompose, model, plan, **CPU)
        ref = _decomposition(jdecompose, model, plan)
        assert mine == ref, (model, plan)
    bugged = _decomposition(decompose, "gpt", plan, bug="wrong_spec",
                            bug_layer=3, **CPU)
    assert bugged == _decomposition(jdecompose, "gpt", plan,
                                    bug="wrong_spec", bug_layer=3)


# ---------------------------------------------------------------------------
# engine parity: JAX captures through the port's engine
# ---------------------------------------------------------------------------





def _jax_graphs(ob):
    gs = jcapture(ob.seq_fn, list(ob.avals), list(ob.input_names))
    gd, r_i = jexpand(jcapture_spmd(ob.dist_fn, dict(ob.mesh_axes),
                                    list(ob.in_specs), list(ob.avals),
                                    list(ob.input_names)))
    return gs, gd, r_i




ENGINE_TASKS = sorted(BENCH["modelcheck"])


@pytest.mark.parametrize("task", ENGINE_TASKS)
def test_engine_parity_bench_counts(task):
    model, plan = task.split("@")
    dec = jdecompose(model, plan)
    fires = steps = 0
    for key in dec.obset.keys_in_order():
        graphs = _jax_graphs(dec.obset.unique[key])
        want = outcome(jcheck, JRefinementError, JT.pretty, *graphs)
        got = outcome(check_refinement, RefinementError, PT.pretty,
                       *carried(*graphs))
        assert got == want, key
        fires += sum(got["fires"].values())
        steps += got["explanation"]["total_steps"]
    bench = BENCH["modelcheck"][task]
    assert (dec.total_blocks, dec.n_unique) == \
        (bench["total_blocks"], bench["unique_obligations"])
    assert (fires, steps) == (bench["lemma_fires"], bench["explain_steps"])


def test_engine_parity_localizes_the_bug():
    dec = jdecompose("gpt", "dp2xtp2", bug="wrong_spec", bug_layer=3)
    graphs = _jax_graphs(dec.obset.unique[dec.obset.blocks[4][1]])
    want = outcome(jcheck, JRefinementError, JT.pretty, *graphs)
    got = outcome(check_refinement, RefinementError, PT.pretty,
                   *carried(*graphs))
    assert got["verdict"] == "refinement_error" and got == want


# ---------------------------------------------------------------------------
# capture parity: the port's own check_model against the JAX one
# ---------------------------------------------------------------------------

def _fires(report):
    return {k: (r.get("stats") or {}).get("lemma_fires")
            for k, r in report.reports.items()}


CAPTURE_TASKS = [(m, "dp2xtp2") for m in
                 ("gpt", "yi-9b", "gemma3-12b", "gemma3-27b",
                  "command-r-35b", "mixtral-8x7b", "kimi-k2-1t-a32b",
                  "qwen2-vl-2b")] + \
    [("gpt", p) for p in ("dp2", "tp2", "dp4")] + [("mixtral-8x7b", "tp2")]
BLOCKS = {"gpt": 14, "yi-9b": 50, "gemma3-12b": 50, "gemma3-27b": 64,
          "command-r-35b": 42, "mixtral-8x7b": 34, "kimi-k2-1t-a32b": 63,
          "qwen2-vl-2b": 30}


@pytest.mark.parametrize("model,plan", CAPTURE_TASKS,
                         ids=[f"{m}@{p}" for m, p in CAPTURE_TASKS])
def test_capture_parity(model, plan):
    mine = check_model(model, plan, workers=0, **CPU)
    ref = jcheck_model(model, plan, workers=0)
    assert mine.verdict == "certificate" and mine.ok
    assert mine.total_blocks == BLOCKS[model]
    assert mine.stable_summary() == ref.stable_summary()
    assert {k: r["r_o"] for k, r in mine.reports.items()} == \
        {k: r["r_o"] for k, r in ref.reports.items()}
    assert _fires(mine) == _fires(ref)
    assert mine.gs_ops_total == ref.gs_ops_total


def test_moe_model_certificate():
    """mixtral-8x7b at tp2: a certificate from 3 unique obligations, as in
    the JAX package (its whole report: ``test_capture_parity``)."""
    report = check_model("mixtral-8x7b", "tp2", workers=0, **CPU)
    assert report.verdict == "certificate" and report.ok
    assert report.unique_obligations == 3


def test_supported_models_are_the_eight():
    assert set(supported_models()) == set(BLOCKS)


# ---------------------------------------------------------------------------
# whole-model verification (tests/test_modelcheck.py on the port)
# ---------------------------------------------------------------------------

def test_gpt_whole_model_certificate():
    report = check_model("gpt", "dp2xtp2", workers=0, **CPU)
    assert report.verdict == "certificate" and report.ok
    assert (report.total_blocks, report.unique_obligations) == (14, 3)
    assert report.dedup_ratio > 1.0
    assert all(b.seam_ok for b in report.blocks)
    assert report.gs_ops_total > 0
    layer_blocks = [b for b in report.blocks if b.name.startswith("layer")]
    assert not layer_blocks[0].cached
    assert all(b.cached for b in layer_blocks[1:])


def test_cache_hit_certificate_byte_identical():
    report = check_model("gpt", "dp2", workers=0, **CPU)
    layers = [b for b in report.blocks if b.name.startswith("layer")]
    (key,) = {b.obligation for b in layers}
    blob = json.dumps(report.reports[key], sort_keys=True)
    for b in layers:
        assert json.dumps(report.reports[b.obligation],
                          sort_keys=True) == blob


@pytest.mark.parametrize("layer", [2, 3])
def test_injected_bug_localizes_to_block(layer):
    report = check_model("gpt", "dp2xtp2", bug="wrong_spec",
                         bug_layer=layer, workers=0, **CPU)
    ref = jcheck_model("gpt", "dp2xtp2", bug="wrong_spec", bug_layer=layer,
                       workers=0)
    assert report.verdict == "refinement_error" and report.ok
    assert report.failing_blocks == [layer + 1]  # embed is block 0
    bad = report.blocks[layer + 1]
    assert bad.name == f"layer{layer}" and not bad.cached
    loc = report.reports[bad.obligation]["localization"]
    keys = ("op_index", "op_name", "out_name")
    assert {k: loc[k] for k in keys} == \
        {k: ref.reports[bad.obligation]["localization"][k] for k in keys}
    assert report.stable_summary() == ref.stable_summary()


@pytest.mark.parametrize("bug", [None, "wrong_spec"])
def test_explanations_match_jax(bug):
    """--explain's roll-up and each obligation's chain or failure frontier
    (the wrong_spec frontier) are the JAX package's."""
    kw = dict(bug=bug, bug_layer=3) if bug else {}
    mine = check_model("gpt", "dp2xtp2", workers=0,
                       engine_opts={"explain": True}, **kw, **CPU)
    ref = jcheck_model("gpt", "dp2xtp2", workers=0,
                       engine_opts={"explain": True}, **kw)
    assert mine.explanation == ref.explanation
    for key in mine.reports:
        assert mine.reports[key]["explanation"] == \
            ref.reports[key]["explanation"]
    kinds = {e["kind"] for e in mine.explanation["per_obligation"].values()}
    assert kinds == ({"certificate", "failure_frontier"} if bug
                     else {"certificate"})


def test_seam_relation_shapes():
    t = expected_output_relation("y", (2, 4, 8), "f",
                                 parse_plan("dp2xtp2").spec_for(
                                     ("batch", "seq", "embed")),
                                 {"dp": 2, "tp": 2})
    assert PT.pretty(t, 999) == "concat(y@dp0,tp0, y@dp1,tp0, dim=0)"
    t = expected_output_relation("y", (2, 4, 8), "f",
                                 parse_plan("dp2").spec_for(
                                     ("batch", "seq", "embed")),
                                 {"dp": 2})
    assert PT.pretty(t, 999) == "concat(y@dp0, y@dp1, dim=0)"


def _stable(report):
    return {k: {f: r.get(f) for f in ("verdict", "r_o", "localization",
                                      "seams")}
            for k, r in report.reports.items()}


def test_scheduler_pool_matches_inprocess():
    """gpt@dp2xtp2 on two spawned workers gives the in-process run's
    stable summary, byte for byte, and its certificates."""
    seq = check_model("gpt", "dp2xtp2", workers=0, **CPU)
    par = check_model("gpt", "dp2xtp2", workers=2, **CPU)
    assert par.workers == 2 and seq.workers == 1
    assert json.dumps(seq.stable_summary(), sort_keys=True) == \
        json.dumps(par.stable_summary(), sort_keys=True)
    assert _stable(seq) == _stable(par)
    assert not any((r.get("runtime") or {}).get("degraded_reason")
                   for r in par.reports.values())


def test_warm_cache_serves_byte_identical_certificates(tmp_path):
    cold = check_model("gpt", "dp2xtp2", workers=0, cache=tmp_path, **CPU)
    warm = check_model("gpt", "dp2xtp2", workers=0, cache=tmp_path, **CPU)
    assert (cold.cache["misses"], cold.cache["hits"]) == (3, 0)
    assert (warm.cache["hits"], warm.cache["misses"]) == (3, 0)
    for key in cold.reports:
        a, b = dict(cold.reports[key]), dict(warm.reports[key])
        a.pop("runtime", None)
        b.pop("runtime", None)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_model_report_json_roundtrip():
    report = check_model("gpt", "dp2", workers=0, **CPU)
    d = report.to_json()
    assert d["schema_version"] >= 1
    assert "timing" in d and "phase_s_sum" in d["timing"]
    back = ModelReport.from_json(json.loads(json.dumps(d)))
    assert back.stable_summary() == report.stable_summary()
    assert "| 13 | head |" in report.to_markdown()


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_model("gpt", "dp2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_main(["--model", "gpt", "--plan", "dp2"])


# ---------------------------------------------------------------------------
# numeric parity and replay
# ---------------------------------------------------------------------------

def _inputs(ob, seed):
    """numpy inputs at a model's scale; token ids negative ones too (the
    gather wraps them as jnp.take does)."""
    out = {n: v.numpy() for n, v in replay_inputs(ob, seed, **CPU).items()}
    if "tokens" in out:
        out["tokens"] = np.random.default_rng(seed).integers(
            -8, 64, out["tokens"].shape).astype(np.int32)
    return out


NUMERIC_TASKS = [("gpt", "dp2xtp2"), ("gemma3-12b", "dp2xtp2"),
                 ("mixtral-8x7b", "tp2"), ("gemma3-27b", "dp4")]


@pytest.mark.parametrize("model,plan", NUMERIC_TASKS,
                         ids=[f"{m}@{p}" for m, p in NUMERIC_TASKS])
def test_blocks_compute_as_jax(model, plan):
    """Each unique block's seq_fn, and per rank its expanded G_d, on the
    same numpy inputs (at a model's scale) in both packages: within 1e-5
    of the output's scale in float32."""
    mine = decompose(model, plan, **CPU)
    ref = jdecompose(model, plan)
    for seed, key in enumerate(ref.obset.keys_in_order()):
        jo, to = ref.obset.unique[key], mine.obset.unique[key]
        values = _inputs(to, seed)
        want = np.asarray(jo.seq_fn(*(jnp.asarray(values[n])
                                      for n in jo.input_names)))
        got = to.seq_fn(*(torch.from_numpy(values[n])
                          for n in to.input_names)).numpy()
        close_to_scale(got, want)
        j_gd, _ = jexpand(jcapture_spmd(
            jo.dist_fn, dict(jo.mesh_axes), list(jo.in_specs),
            list(jo.avals), list(jo.input_names)))
        t_gd, _ = expand_spmd(capture_spmd(
            to.dist_fn, dict(to.mesh_axes), list(to.in_specs),
            list(to.avals), list(to.input_names), **CPU))
        shards = shard(values, jo.input_names, jo.in_specs,
                        dict(jo.mesh_axes))
        gw = run(j_gd, shards, jeval)
        gt = run(t_gd, {k: torch.from_numpy(v) for k, v in shards.items()},
                  eval_term)
        assert list(gt) == list(gw)          # one output per rank, same names
        for o in gw:
            close_to_scale(gt[o], gw[o])


@pytest.mark.parametrize("model,plan", [("gpt", "dp2xtp2"),
                                        ("mixtral-8x7b", "tp2"),
                                        ("gemma3-12b", "dp2xtp2")])
def test_certificates_replay(model, plan):
    """Each clean certificate rebuilds the sequential outputs from G_d's
    values within rtol = atol = 2e-4, on inputs at a model's scale."""
    dec = decompose(model, plan, **CPU)
    for key in dec.obset.keys_in_order():
        ob = dec.obset.unique[key]
        got, want = replay(ob.to_strategy_spec(name=key), "cpu",
                           inputs=replay_inputs(ob, **CPU))
        assert set(got) == set(want) and got
        assert max_rel_excess(got, want) <= 1.0, key


def _as_f64(v):
    v = torch.as_tensor(np.asarray(v))
    return v.double() if v.dtype == torch.float32 else v


def _eval64(graph, inputs) -> dict:
    """Every value of ``graph`` evaluated def by def in float64: float32
    inputs and constants widened, literals as eval_term takes them."""
    env = {k: _as_f64(v) for k, v in graph.consts.items()}
    env.update({k: _as_f64(v) for k, v in inputs.items()})
    for name, term in graph.defs:
        env[name] = eval_term(term, env, "cpu")
    return env


@pytest.mark.parametrize("model,plan", [("gpt", "dp2xtp2"),
                                        ("mixtral-8x7b", "tp2"),
                                        ("gemma3-12b", "dp2xtp2")])
def test_standard_draw_is_float32_rounding(model, plan, capsys):
    """Why block replays draw at a model's scale: at the replay's standard
    draw (N(0, 0.3^2) for every float input) float32 rounding alone can
    put an element of a block's ~6,500-scale output beyond rtol = atol =
    2e-4.  The witness, per clean obligation, on that draw: G_s and G_d
    evaluated in float64 rebuild the outputs through the certificate
    exactly (excess <= 1e-6), and the port's float32 sequential and
    rebuilt outputs, like the JAX package's float32 ``seq_fn``, sit within
    2e-6 of the output's scale (~16 float32 ulps) of that float64 value.
    Run with ``-s`` to print each reading."""
    mine = decompose(model, plan, **CPU)
    ref = jdecompose(model, plan)
    for key in mine.obset.keys_in_order():
        ob, jo = mine.obset.unique[key], ref.obset.unique[key]
        spec = ob.to_strategy_spec(name=key)
        ints = {n: v for n, v in replay_inputs(ob, **CPU).items()
                if not v.dtype.is_floating_point}
        got, want = replay(spec, "cpu", inputs=ints)
        gs, gd, r_i = capture_task(spec, "cpu")
        cert = check_refinement(gs, gd, r_i)
        g = torch.Generator().manual_seed(REPLAY_SEED)
        values = {n: ints[n] if n in ints else
                  torch.randn(tuple(shape), generator=g, dtype=dtype)
                  * REPLAY_SCALE
                  for n, (shape, dtype) in zip(spec.input_names, spec.avals)}
        exact = {n: _as_f64(v) for n, v in values.items()}
        got64 = cert.reconstruct(_eval64(gd, shard_inputs(r_i, exact)),
                                 "cpu")
        senv = _eval64(gs, exact)
        want64 = {k: senv[k] for k in got64}
        assert all(v.dtype == torch.float64 for v in got64.values())
        assert max_rel_excess(got64, want64) <= 1e-6, key
        (out,) = want64
        jw = np.array(jo.seq_fn(*(jnp.asarray(values[n].numpy())
                                  for n in jo.input_names)))
        for fp32 in (got[out], want[out], jw):
            close_to_scale(fp32, want64[out], tol=2e-6)
        with capsys.disabled():
            print(f"\n{model}@{plan} {key}: float32 excess "
                  f"{max_rel_excess(got, want)}, float64 excess "
                  f"{max_rel_excess(got64, want64)}, JAX float32 seq_fn "
                  f"against the port's rebuilt output "
                  f"{max_rel_excess({out: torch.from_numpy(jw)}, got)}")


# ---------------------------------------------------------------------------
# registry entries, CLI, capture_chain, cache fingerprint
# ---------------------------------------------------------------------------

def test_model_task_registry():
    tasks = list_model_tasks()
    from repro.api import list_model_tasks as jlist
    assert tasks == jlist()
    assert f"gpt@{DEFAULT_PLANS[0]}" in tasks
    assert set(t.split("@", 1)[0] for t in tasks) == set(supported_models())
    with pytest.raises(KeyError):
        check_model_task("gpt")          # missing @plan


def test_check_model_task_runs():
    report = check_model_task("gpt@dp2", workers=0, **CPU)
    assert report.verdict == "certificate"


def _envelope(capsys, main, argv):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, json.loads(capsys.readouterr().out)


def _strip_timing(env):
    env = json.loads(json.dumps(env))
    env.pop("timing")
    rep = env["report"]
    for k in ("wall_s", "timing", "pool", "workers"):
        rep.pop(k, None)
    for nested in rep["reports"].values():
        nested.pop("wall_s", None)
        stats = nested.get("stats") or {}
        for k in ("time_s", "phase_s", "counters"):
            stats.pop(k, None)
    return env


@pytest.mark.parametrize("argv", [
    ["--model", "gpt", "--plan", "dp2", "--json"],
    ["--model", "gpt", "--plan", "dp2xtp2", "--inject-bug", "wrong_spec",
     "--bug-layer", "3", "--json"]], ids=["clean", "wrong_spec"])
def test_cli_model_json_envelope_matches_jax(capsys, argv):
    from repro.launch.verify import main as jmain
    rc, env = _envelope(capsys, verify_main, argv + ["--device", "cpu"])
    jrc, jenv = _envelope(capsys, jmain, argv)
    assert rc == jrc == (1 if "--inject-bug" in argv else None)
    assert env["schema_version"] == 2 and env["kind"] == "model"
    assert set(env) == set(jenv)
    assert "phase_s_sum" in env["timing"]
    assert set(env["report"]) == set(jenv["report"])
    assert _strip_timing(env) == _strip_timing(jenv)


def test_cli_model_text_and_exit_codes(capsys):
    verify_main(["--model", "gpt", "--plan", "dp2", "--device", "cpu"])
    assert "WHOLE-MODEL REFINEMENT HOLDS (3 obligations verified for 14 " \
        "blocks" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        verify_main(["--model", "gpt", "--inject-bug", "wrong_spec",
                     "--bug-layer", "3", "--device", "cpu"])
    assert e.value.code == 1
    assert "failing blocks [4]" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        verify_main(["--model", "mamba2-1.3b", "--device", "cpu"])
    assert e.value.code == 2


def test_cli_case_json_envelope(capsys):
    verify_main(["--case", "tp_layer", "--json", "--device", "cpu"])
    env = json.loads(capsys.readouterr().out)
    assert env["schema_version"] == 2 and env["kind"] == "case"
    assert env["report"]["verdict"] == "certificate"
    assert set(env["timing"]) == {"wall_s", "infer_s", "phase_s"}


def test_capture_chain_threads_names_and_avals():
    def blk(x, w):
        return torch.tanh(x @ w)

    aval = ((4, 4), torch.float32)
    graphs, carry_avals, carry_names = capture_chain(
        [("b0", blk, [aval], ["w"]), ("b1", blk, [aval], ["w"])],
        [aval], ["x"], **CPU)
    assert [n for n, _ in graphs] == ["b0", "b1"]
    g0, g1 = graphs[0][1], graphs[1][1]
    assert g0.inputs == ["x", "b0.w"]
    assert g1.inputs == ["b0.out0", "b1.w"]   # seam: names thread
    assert carry_names == ["b1.out0"]
    assert carry_avals == [((4, 4), torch.float32)]
    assert g0.n_ops == g1.n_ops == 2


def test_sequential_chain_op_count():
    dec = decompose("gpt", "dp2", **CPU)
    graphs, _, names = dec.sequential_chain()
    assert len(graphs) == dec.total_blocks
    assert names == ["head.out0"]
    total = sum(g.n_ops for _, g in graphs)
    jgraphs, _, _ = jdecompose("gpt", "dp2").sequential_chain()
    assert total == sum(g.n_ops for _, g in jgraphs) > 14 * 10


def test_fingerprint_hashes_modelcheck(tmp_path, monkeypatch):
    """Editing a file under modelcheck/ (in a copy of the package)
    changes the engine fingerprint; the hashed set is the JAX one."""
    src = os.path.join(ROOT, "src", "repro_torch")
    pkg = tmp_path / "repro_torch"
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    # the fingerprint hashes the package its module file sits in
    monkeypatch.setattr(cache_mod, "__file__",
                        str(pkg / "runtime" / "cache.py"))
    engine_fingerprint.cache_clear()
    before = engine_fingerprint()
    assert before == engine_fingerprint()
    blocks = pkg / "modelcheck" / "blocks.py"
    blocks.write_text(blocks.read_text() + "\n# edited\n")
    engine_fingerprint.cache_clear()
    assert engine_fingerprint() != before
    # a file outside the hashed parts leaves it alone
    edited = engine_fingerprint()
    verify = pkg / "launch" / "verify.py"
    verify.write_text(verify.read_text() + "\n# edited\n")
    engine_fingerprint.cache_clear()
    assert engine_fingerprint() == edited
    monkeypatch.undo()
    engine_fingerprint.cache_clear()
    assert engine_fingerprint() != edited

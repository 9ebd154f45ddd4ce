"""Engine parity: the port's relation inference against the JAX package's.

Each registered case is captured by the JAX package at degrees 2 and 4,
clean and with each of its bugs, carried across in its plain object form
(``repro_torch.core.convert``), and run through both engines in this
process, with proof provenance on. The port must give the same verdict,
the same ``pretty(R_o)``, the same localization and failure frontier, the
same per-lemma fires, e-graph size and explanation (so the same
``explain_steps``). The counts in ``BENCH_verify.json`` (deterministic:
fires, e-graph nodes, explanation steps, op counts) are held too.
``eval_term`` on torch is held against the JAX package's numpy one, op by
op: exact for ints and bools, rtol 1e-6 for float32, and in numpy's dtype.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import (RefinementError as JRefinementError, capture,
                        capture_spmd, check_refinement as jcheck,
                        expand_spmd)
from repro.core import terms as JT
from repro.core.explain import term_to_obj

from repro_torch.core import RefinementError, check_refinement
from repro_torch.core import terms as PT
from repro_torch.core.convert import (graph_from_obj, relation_from_obj,
                                      term_from_obj)
from repro_torch.core.explain import check_explanation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCH_verify.json")))

TASKS = [(case, deg, None) for case in japi.list_strategies()
         for deg in (2, 4)] + \
        [(host, deg, bug)
         for bug, (host, _) in sorted(japi.list_bugs().items())
         for deg in (2, 4)]


def _graph_obj(g):
    return {"inputs": g.inputs, "outputs": g.outputs,
            "defs": [[n, term_to_obj(t)] for n, t in g.defs],
            "shapes": g.shapes, "dtypes": g.dtypes, "consts": g.consts}


def _jax_capture(case, degree, bug=None):
    spec = japi.build_spec(case, degree=degree, bug=bug)
    gs = capture(spec.seq_fn, list(spec.avals), list(spec.input_names))
    cap = capture_spmd(spec.dist_fn, spec.mesh_axes, list(spec.in_specs),
                       list(spec.avals), list(spec.input_names))
    gd, r_i = expand_spmd(cap)
    return gs, gd, r_i


def _carried(gs, gd, r_i):
    return (graph_from_obj(_graph_obj(gs)), graph_from_obj(_graph_obj(gd)),
            relation_from_obj({n: [term_to_obj(t) for t in ts]
                                for n, ts in r_i.items()}))


def _outcome(check, err_type, pretty, gs, gd, r_i):
    try:
        cert = check(gs, gd, r_i, explain=True)
    except err_type as e:
        return {"verdict": "refinement_error", "payload": e.payload(),
                "explanation": e.explanation}
    stats = cert.stats
    return {"verdict": "certificate",
            "r_o": [(k, pretty(v, 999)) for k, v in cert.r_o.items()],
            "counts": {k: stats[k] for k in ("egraph_nodes", "gs_ops",
                                             "gd_ops", "lemma_fires",
                                             "lemmas", "counters")},
            "explanation": cert.explanation,
            "explain_steps": cert.explanation["total_steps"]}


def _both(gs, gd, r_i):
    want = _outcome(jcheck, JRefinementError, JT.pretty, gs, gd, r_i)
    got = _outcome(check_refinement, RefinementError, PT.pretty,
                   *_carried(gs, gd, r_i))
    return got, want


@pytest.mark.parametrize("case,degree,bug", TASKS,
                         ids=[f"{c}@{d}{'+' + b if b else ''}"
                              for c, d, b in TASKS])
def test_engine_parity(case, degree, bug):
    got, want = _both(*_jax_capture(case, degree, bug))
    assert got == want
    expected = japi.get_strategy(case).expected if bug is None else \
        japi.get_strategy(case).bug_spec(bug).expected
    assert got["verdict"] == {"certificate": "certificate",
                              "refinement_error": "refinement_error",
                              "unexpected_relation": "certificate"}[expected]


def _bench_tasks():
    out = []
    for section in ("fig4", "fig5", "fam_scaling"):
        for key, entry in BENCH[section].items():
            case, _, deg = key.rpartition("_deg") if "_deg" in key \
                else (key, "", "2")
            degree = japi.parse_degree(deg)
            if max(np.atleast_1d(degree)) > 4:
                continue              # degree 8 stays in the benchmark
            out.append((section, key, case, degree, entry))
    return out


@pytest.mark.parametrize("section,key,case,degree,entry", _bench_tasks(),
                         ids=[f"{s}:{k}" for s, k, *_ in _bench_tasks()])
def test_bench_counts(section, key, case, degree, entry):
    """The port's engine on the JAX capture reproduces the benchmark's
    deterministic counts (fig4 ep_moe fires 14, tp_dp_2d 4x4 fires 83)."""
    got = _outcome(check_refinement, RefinementError, PT.pretty,
                   *_carried(*_jax_capture(case, degree)))
    assert got["verdict"] == "certificate"
    counts = got["counts"]
    assert sum(counts["lemma_fires"].values()) == entry["lemma_fires"]
    assert counts["egraph_nodes"] == entry["egraph_nodes"]
    assert counts["gs_ops"] == entry["gs_ops"]
    assert counts["gd_ops"] == entry["gd_ops"]
    assert got["explain_steps"] == entry["explain_steps"]


def test_named_targets():
    assert BENCH["fig4"]["ep_moe"]["lemma_fires"] == 14
    assert BENCH["fam_scaling"]["tp_dp_2d_deg4x4"]["lemma_fires"] == 83
    for case, degree, fires in (("ep_moe", 2, 14), ("tp_dp_2d", 4, 83)):
        got, want = _both(*_jax_capture(case, degree))
        assert sum(got["counts"]["lemma_fires"].values()) == fires
        assert got == want


@pytest.mark.parametrize("case", ["tp_layer", "fsdp_mlp", "grad_accum"])
def test_port_explanation_replays(case):
    """The port's replay checker accepts the port's own lemma chains."""
    cert = check_refinement(*_carried(*_jax_capture(case, 2)), explain=True)
    res = check_explanation(cert.explanation, device="cpu")
    assert res["ok"], res["failures"]
    assert res["checked_steps"] == cert.explanation["total_steps"]


# ---------------------------------------------------------------------------
# eval_term: torch against numpy, op by op
# ---------------------------------------------------------------------------

RNG_SEED = 0
F32 = np.float32


def _inputs():
    rng = np.random.default_rng(RNG_SEED)
    return {
        "a": rng.standard_normal((3, 4)).astype(F32),
        "b": rng.standard_normal((3, 4)).astype(F32),
        "p": rng.uniform(0.5, 2.0, (3, 4)).astype(F32),
        "m": rng.standard_normal((4, 5)).astype(F32),
        "bb": rng.standard_normal((2, 3, 4)).astype(F32),
        "bm": rng.standard_normal((2, 4, 5)).astype(F32),
        "d": rng.standard_normal((3, 4)),
        "i": rng.integers(-5, 6, (3, 4)),
        "j": rng.integers(1, 4, (3, 4)),
        "k": rng.integers(0, 3, (3, 4)).astype(np.int32),
        "u": rng.integers(0, 2, (3, 4)).astype(bool),
        "v": rng.integers(0, 2, (3, 4)).astype(bool),
        "tab": rng.standard_normal((5, 4)).astype(F32),
        "idx": rng.integers(0, 5, (3,)),
        "col": rng.standard_normal((3, 1)).astype(F32),
    }


def _t(name, env):
    v = env[name]
    kind = {"f": "f", "i": "i", "b": "b"}[v.dtype.kind]
    return JT.tensor(name, v.shape, kind)


def _term_cases():
    env = _inputs()
    a, b, p, i, j, k, u, v = (_t(n, env) for n in "abpijkuv")
    m, d, bb, bm = (_t(n, env) for n in ("m", "d", "bb", "bm"))
    tab, idx, col = (_t(n, env) for n in ("tab", "idx", "col"))
    positive = {"log", "sqrt", "rsqrt", "log1p"}
    cases = {}
    for op in sorted(JT.EW1_OPS):
        arg = u if op == "not" else p if op in positive else a
        cases[f"ew1:{op}"] = JT.ew1(op, arg)
    cases["ew1:exp_of_int"] = JT.ew1("exp", i)
    cases["ew1:floor_of_int"] = JT.ew1("floor", i)
    cases["ew1:erf_of_int"] = JT.ew1("erf", i)
    cases["integer_pow"] = JT.integer_pow(a, 3)
    cases["integer_pow:int"] = JT.integer_pow(i, 2)
    for op in sorted(JT.EW2_OPS):
        x, y = (u, v) if op in ("and", "or") else \
            (i, j) if op in ("shift_left", "shift_right") else \
            (p, a) if op == "pow" else (a, b)
        cases[f"ew2:{op}"] = JT.ew2(op, x, y)
    cases["ew2:rem_int"] = JT.ew2("rem", i, j)
    cases["ew2:div_int"] = JT.ew2("div", i, j)
    cases["ew2:mul_f32_lit"] = JT.ew2("mul", a, JT.lit(2.5))
    cases["ew2:add_int_lit"] = JT.ew2("add", i, JT.lit(3))
    cases["ew2:add_f32_f64"] = JT.ew2("add", a, d)
    cases["ew2:mul_int32_int64"] = JT.ew2("mul", k, i)
    cases["ew2:lt_f32_lit"] = JT.ew2("lt", a, JT.lit(0.1))
    cases["add_n"] = JT.add_n([a, b, p, a])
    cases["matmul"] = JT.matmul(a, m)
    cases["bmm"] = JT.bmm(bb, bm)
    cases["concat"] = JT.concat([a, b, p], 0)
    cases["concat:mixed"] = JT.concat([a, d], 1)
    cases["slice"] = JT.slice_(a, (1, 0), (3, 3))
    cases["transpose"] = JT.transpose(a, (1, 0))
    cases["reshape"] = JT.reshape(a, (2, 6))
    cases["broadcast"] = JT.broadcast(JT.reshape(a, (3, 4)), (2, 3, 4),
                                      (1, 2))
    cases["broadcast:lit"] = JT.broadcast(JT.lit(1.5), (2, 3), ())
    cases["broadcast:size1"] = JT.broadcast(col, (3, 4), (0, 1))
    for to in "fib":
        cases[f"convert:{to}"] = JT.convert(a, to)
    cases["convert:int_to_f"] = JT.convert(i, "f")
    cases["rev"] = JT.rev(a, (0, 1))
    for op in sorted(JT.REDUCE_OPS):
        arg = u if op in ("reduce_and", "reduce_or") else \
            p if op == "reduce_prod" else a
        cases[f"{op}"] = JT.reduce_(op, arg, (1,))
        cases[f"{op}:all"] = JT.reduce_(op, arg, (0, 1))
    cases["reduce_sum:none"] = JT.reduce_("reduce_sum", u, ())
    cases["reduce_sum:bool"] = JT.reduce_("reduce_sum", u, (0,))
    cases["reduce_sum:int32"] = JT.reduce_("reduce_sum", k, (0,))
    cases["gather_rows"] = JT.gather_rows(tab, idx)
    cases["select"] = JT.select(u, a, b)
    cases["select:mixed"] = JT.select(u, a, d)
    cases["iota"] = JT.iota((3, 4), 1)
    cases["dus"] = JT.dus(a, JT.slice_(b, (0, 0), (2, 2)), (1, 2))
    cases["cumsum"] = JT.cumsum(a, 1)
    cases["cumsum:bool"] = JT.cumsum(u, 0)
    cases["argmax"] = JT.argmax(a, 1)
    cases["lit:float"] = JT.lit(0.25)
    cases["lit:int"] = JT.lit(7)
    return env, cases


_ENV, _CASES = _term_cases()
_SUMS = ("reduce_sum", "cumsum", "matmul", "bmm", "add_n")


@pytest.mark.parametrize("name", sorted(_CASES))
def test_eval_term_matches_numpy(name):
    jterm = _CASES[name]
    want = np.asarray(JT.eval_term(jterm, _ENV))
    got = PT.eval_term(term_from_obj(term_to_obj(jterm)),
                       {k: torch.from_numpy(v) for k, v in _ENV.items()})
    assert isinstance(got, torch.Tensor)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    rtol = 1e-6 if want.dtype == np.float32 else 1e-12
    if name.startswith(_SUMS):
        # numpy sums float32 pairwise, torch in its own order: each order
        # is within rtol * sum|x| of the exact sum, which cancellation can
        # make far larger than rtol * |sum|
        scale = np.abs(JT.eval_term(jterm, {k: np.abs(v)
                                            for k, v in _ENV.items()}))
        assert np.all(np.abs(got.numpy() - want) <= rtol * scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


def test_eval_term_makes_literals_on_the_env_device():
    t = PT.ew2("add", PT.tensor("x", (2,), "f"), PT.lit(1.0))
    out = PT.eval_term(t, {"x": np.ones(2, np.float32)}, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float64
    assert PT.eval_term(PT.lit(3), {}).device.type == "cpu"

"""Capture parity: the 11 cases written in torch against the JAX ones.

Each torch case is captured with ``make_fx`` by the port and verified on
the CPU. At degree 2 it must give the JAX case's verdict and expectation,
an R_o equal to ``tests/golden/suite_degree2.json`` up to a renaming of
``t<N>`` names, and each bug must localize to the same operator. On the
same numpy inputs, the torch G_s and G_d evaluated with the port's
``eval_term`` equal the JAX G_s and G_d evaluated with the JAX package's
(rtol 2e-4, the JAX replay test's). The strict frontend names the user's
own ``file:line`` for an aten op outside the table.
"""
import inspect
import itertools
import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import capture as jcapture, capture_spmd as jcapture_spmd
from repro.core import expand_spmd as jexpand
from repro.core.terms import eval_term as jeval

from repro_torch import api as tapi
from repro_torch.api.report import same_up_to_renaming
from repro_torch.api.replay import max_rel_excess, replay, shard_inputs
from repro_torch.core import (CaptureError, UnsupportedPrimitive, capture,
                              capture_spmd, check_refinement, expand_spmd,
                              spmd, strict_capture)
from repro_torch.core.explain import check_explanation, replay_env
from repro_torch.core.terms import eval_term

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = json.load(open(os.path.join(ROOT, "tests/golden/suite_degree2.json")))
CASES = list(japi.list_strategies())
BUGS = sorted(japi.list_bugs().items())


def test_same_case_matrix_as_jax():
    assert list(tapi.list_strategies()) == CASES
    for name in CASES:
        j, t = japi.get_strategy(name), tapi.get_strategy(name)
        assert t.degrees == j.degrees and t.expected == j.expected
        assert t.bugs == tuple(tapi.BugSpec(b.name, b.expected, b.description)
                               for b in j.bugs)
        js, ts = japi.build_spec(name), tapi.build_spec(name, device="cpu")
        assert ts.mesh_axes == js.mesh_axes
        assert ts.input_names == js.input_names
        assert [tuple(s) for s in ts.in_specs] == \
            [tuple(s) for s in js.in_specs]
        assert [tuple(a.shape) for a in ts.avals] == \
            [tuple(a.shape) for a in js.avals]
        assert all(a.dtype == torch.float32 for a in ts.avals)


@pytest.mark.parametrize("case", CASES)
def test_clean_case_matches_golden(case):
    r = tapi.verify(case, degree=2, device="cpu")
    g = GOLDEN[f"{case}@deg2"]
    assert (r.verdict, r.expected, r.ok) == (g["verdict"], g["expected"],
                                             g["ok"]), r.error
    assert same_up_to_renaming(r.r_o, g["r_o"]), (r.r_o, g["r_o"])


@pytest.mark.parametrize("bug,host", [(b, h) for b, (h, _) in BUGS])
def test_bug_surfaces_as_jax(bug, host):
    r = tapi.verify(host, bug=bug, degree=2, device="cpu")
    j = japi.verify(host, bug=bug, degree=2)
    assert (r.verdict, r.expected, r.ok) == (j.verdict, j.expected, True)
    if j.verdict == "refinement_error":
        keys = ("op_index", "op_name", "out_name")
        assert {k: r.localization[k] for k in keys} == \
            {k: j.localization[k] for k in keys}
    else:                        # unexpected_relation: a clean certificate
        assert same_up_to_renaming(r.r_o, j.r_o), (r.r_o, j.r_o)
        assert not same_up_to_renaming(
            r.r_o, GOLDEN[f"{host}@deg2"]["r_o"])


# Per-rank defs the JAX capture has and the torch capture does not: jax's
# dynamic_slice normalizes a traced start (lt, add, select, for each of the
# two tables), and jnp.pad converts its int pad value in a def of its own;
# torch's dynamic_slice takes the start as it is and F.pad's value is a
# float literal.
EXTRA_JAX_DEFS_PER_RANK = {"sp_rope": 6, "sp_pad": 1}
COUNT_TASKS = [(c, d, b) for c in CASES for d in japi.get_strategy(c).degrees
               if max(np.atleast_1d(d)) <= 4
               for b in (None,) + japi.get_strategy(c).bug_names()]


@pytest.mark.parametrize("case,degree,bug", COUNT_TASKS, ids=[
    f"{c}@{japi.degree_token(d)}{'+' + b if b else ''}"
    for c, d, b in COUNT_TASKS])
def test_counts_against_jax_capture(case, degree, bug):
    """Same verdict, localization and lemma fires as the JAX capture at
    degrees 2 and 4; G_d op counts differ only where jax's lowering adds
    defs."""
    j = japi.verify(case, degree=degree, bug=bug)
    t = tapi.verify(case, degree=degree, bug=bug, device="cpu")
    assert (t.verdict, t.ok) == (j.verdict, j.ok)
    if j.verdict != "certificate":
        assert t.localization["op_index"] == j.localization["op_index"]
        return
    js, ts = j.stats, t.stats
    assert ts["lemma_fires"] == js["lemma_fires"]
    assert ts["gs_ops"] == js["gs_ops"]
    ranks = int(np.prod(list(japi.build_spec(case, degree=degree)
                             .mesh_axes.values())))
    assert js["gd_ops"] - ts["gd_ops"] == \
        EXTRA_JAX_DEFS_PER_RANK.get(case, 0) * ranks
    if case not in EXTRA_JAX_DEFS_PER_RANK:
        assert ts["egraph_nodes"] == js["egraph_nodes"]


def _shard(values, names, specs, mesh_axes):
    """Per-rank numpy pieces of the global inputs (``name@tag`` keys)."""
    axes = list(mesh_axes)
    env = {}
    for coords in itertools.product(*(range(mesh_axes[a]) for a in axes)):
        at = dict(zip(axes, coords))
        tag = "@" + ",".join(f"{a}{c}" for a, c in zip(axes, coords))
        for name, spec in zip(names, specs):
            piece = values[name]
            for d, entry in enumerate(tuple(spec)):
                if entry is None:
                    continue
                group = (entry,) if isinstance(entry, str) else entry
                k, n = 0, 1
                for a in group:          # major to minor
                    k, n = k * mesh_axes[a] + at[a], n * mesh_axes[a]
                size = piece.shape[d] // n
                piece = np.take(piece, range(k * size, (k + 1) * size),
                                axis=d)
            env[name + tag] = piece
    return env


def _run(graph, env, evaluate):
    env = dict(env)
    env.update(graph.consts)
    for name, term in graph.defs:
        env[name] = evaluate(term, env)
    return [np.asarray(env[o].numpy() if isinstance(env[o], torch.Tensor)
                       else env[o], dtype=np.float64) for o in graph.outputs]


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_graphs_evaluate_as_jax(case):
    """G_s and the expanded G_d of the torch capture compute what the JAX
    capture's do, on the same numpy inputs."""
    js = japi.build_spec(case, degree=2)
    ts = tapi.build_spec(case, degree=2, device="cpu")
    rng = np.random.default_rng(0)
    values = {n: (rng.standard_normal(tuple(a.shape)) * 0.3).astype(np.float32)
              for n, a in zip(js.input_names, js.avals)}
    tvals = {n: torch.from_numpy(v) for n, v in values.items()}
    j_gs = jcapture(js.seq_fn, list(js.avals), list(js.input_names))
    t_gs = capture(ts.seq_fn, list(ts.avals), list(ts.input_names),
                   device="cpu")
    _close(_run(t_gs, tvals, eval_term), _run(j_gs, values, jeval))
    j_gd, _ = jexpand(jcapture_spmd(js.dist_fn, js.mesh_axes,
                                    list(js.in_specs), list(js.avals),
                                    list(js.input_names)))
    t_gd, t_ri = expand_spmd(capture_spmd(ts.dist_fn, ts.mesh_axes,
                                          list(ts.in_specs), list(ts.avals),
                                          list(ts.input_names),
                                          device="cpu"))
    shards = _shard(values, js.input_names, js.in_specs, js.mesh_axes)
    assert set(shards) == set(t_gd.inputs) == set(j_gd.inputs)
    _close(_run(t_gd, {k: torch.from_numpy(v) for k, v in shards.items()},
                eval_term), _run(j_gd, shards, jeval))
    # sharding per R_i gives the same pieces as sharding per the specs
    by_ri = shard_inputs(t_ri, tvals)
    assert set(by_ri) == set(shards)
    for k, v in by_ri.items():
        np.testing.assert_array_equal(v.numpy(), shards[k])


@pytest.mark.parametrize("case", CASES)
def test_certificate_replays_numerically(case):
    got, want = replay(tapi.build_spec(case, degree=2, device="cpu"), "cpu")
    assert set(got) == set(want) and got
    assert max_rel_excess(got, want) <= 1.0


def _unsupported(x):
    return torch.cumprod(x, 0)


def test_unsupported_op_names_the_users_line():
    line = inspect.getsourcelines(_unsupported)[1] + 1
    with pytest.raises(UnsupportedPrimitive) as exc:
        with strict_capture():
            capture(_unsupported, [((4,), torch.float32)], ["x"],
                    device="cpu")
    assert exc.value.primitive == "aten.cumprod"
    assert exc.value.source.startswith(f"{os.path.abspath(__file__)}:{line}")
    assert f"test_torch_capture.py:{line} (_unsupported)" in str(exc.value)
    with pytest.raises(CaptureError, match="aten.cumprod"):
        capture(_unsupported, [((4,), torch.float32)], ["x"], device="cpu")


def test_strided_slice_is_refused():
    with pytest.raises(UnsupportedPrimitive, match="aten.slice"):
        with strict_capture():
            capture(lambda x: x[::2], [((4,), torch.float32)], ["x"],
                    device="cpu")


def test_aten_lowerings_mirror_jax():
    """The idioms the cases use lower to the JAX capture's terms."""
    f = torch.float32
    g = capture(lambda x, w: (x[:, 2:], w[0], torch.nn.functional.pad(
        x, (0, 0, 0, 2)), x.sum(0) / 2, torch.sigmoid(x), x[None], x.T),
        [((4, 8), f), ((3, 8, 8), f)], ["x", "w"], device="cpu")
    ops = [t.op if t.op != "tensor" else "leaf" for _, t in g.defs]
    assert ops == ["slice", "slice", "reshape", "concat", "reduce_sum", "div",
                   "logistic", "broadcast", "transpose"]
    defs = dict(g.defs)
    assert defs[g.outputs[0]].attr("limits") == (4, 8)   # end clamped
    div = defs[g.outputs[3]]
    assert div.args[1].op == "broadcast" and div.args[1].args[0].value == 2.0


def _table_ops(x, y, w, b, i, m):
    """One use of each aten op in the capture's table."""
    z = torch.where(x > 0, x, y) + torch.clamp(y, -0.5, 0.5)
    z = z + torch.nn.functional.linear(x, w, b) + torch.addmm(b, x, w)
    z = z * x.mean(1, keepdim=True) - (1.0 - y) + x ** 2 + 2.0 ** y
    z = torch.maximum(z, y) + torch.minimum(x, y) + torch.remainder(x, 0.7)
    z = z + torch.exp(-x.abs()) + torch.sqrt(y.abs() + 1) * torch.rsqrt(
        y * y + 1) + torch.log1p(x.abs()) + torch.expm1(y) + torch.erf(x)
    z = z + torch.sin(x) * torch.cos(y) + torch.floor(x) + torch.sign(y)
    z = z + torch.relu(x) + torch.sigmoid(y) + torch.tanh(x) - torch.neg(y)
    a, c = torch.split(z, [1, 3], dim=0)
    z = torch.cat([c, a], 0).transpose(0, 1).t().contiguous()
    s = z.sum() + z.amax(0).sum() + z.amin(1).sum() + (z * 0.1).prod(1).sum()
    flags = (z > 0).all(1).float().sum() + (z < -9).any().float()
    rows = torch.nn.functional.embedding(i, m).sum(0)
    ramp = torch.arange(4, device=x.device).to(x.dtype)
    full = torch.full((4,), 0.5, device=x.device) + torch.ones(4,
                                                               device=x.device)
    out = z.cumsum(1)[:, 1:] + x.unsqueeze(0).expand(2, 4, 4)[1, :, 1:]
    x3 = x.detach().reshape(2, 2, 4)
    mix = torch.bmm(x3, x3.transpose(1, 2)).sum() + (x3 @ w).sum() \
        + torch.atan2(x, y).sum() + torch.full_like(x, 0.25).sum() \
        + torch.nn.functional.pad(x, (1, 2, 0, 1), value=0.5).sum()
    return (out.reshape(-1).squeeze(), s + flags + mix, rows + ramp + full,
            z.argmax(1), torch.zeros_like(x) + torch.ones_like(y),
            (x != y) & (x >= 0) | (y <= 0))


def test_lowering_table_evaluates_as_torch():
    """Every lowering in the table computes what the aten op computes."""
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(4, 4, generator=g) for _ in range(3)] + \
        [torch.randn(4, generator=g), torch.tensor([0, 2, 1]),
         torch.randn(3, 4, generator=g)]
    names = ["x", "y", "w", "b", "i", "m"]
    graph = capture(_table_ops, [(a.shape, a.dtype) for a in args], names,
                    device="cpu")
    env = dict(zip(names, args))
    env.update(graph.consts)
    for name, term in graph.defs:
        env[name] = eval_term(term, env)
    want = _table_ops(*args)
    assert len(graph.outputs) == len(want)
    for o, w in zip(graph.outputs, want):
        got = env[o] if o in env else torch.as_tensor(graph.consts[o])
        assert got.shape == w.shape, o
        torch.testing.assert_close(got.to(w.dtype), w, rtol=1e-5, atol=1e-5)


def test_spmd_shim_and_functional_collective_names_agree():
    f = torch.float32
    avals = [((4, 8), f), ((8, 8), f)]
    specs = (spmd.P("dp", None), spmd.P("dp", None))

    def lax_style(x, w):
        w = spmd.all_gather(w, "dp", axis=0, tiled=True)
        y = spmd.psum(x @ w, "dp")
        return spmd.psum_scatter(y, "dp", scatter_dimension=0, tiled=True)

    def funcol_style(x, w):
        w = spmd.all_gather_tensor(w, 0, "dp")
        y = spmd.all_reduce(x @ w, "sum", "dp")
        return spmd.reduce_scatter_tensor(y, "sum", 0, "dp")

    wrapped = spmd.shard_map(funcol_style, {"dp": 2}, specs)
    a = capture_spmd(lax_style, {"dp": 2}, specs, avals, ["x", "w"],
                     device="cpu")
    b = capture_spmd(wrapped, {"dp": 2}, specs, avals, ["x", "w"],
                     device="cpu")
    assert a.graph.defs == b.graph.defs
    assert [t.op for _, t in a.graph.defs] == \
        ["all_gather", "matmul", "psum", "reduce_scatter"]
    with pytest.raises(RuntimeError, match="inside a mesh"):
        spmd.psum(torch.ones(2), "dp")
    assert wrapped(torch.ones(2, 8), torch.ones(4, 8)).shape == (1, 8)


def test_get_attr_constants_are_host_numpy():
    spec = tapi.build_spec("sp_rope", degree=2, device="cpu")
    g = capture(spec.seq_fn, list(spec.avals), list(spec.input_names),
                device="cpu")
    assert sorted(g.consts) == ["const0", "const1"]
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in g.consts.values())
    cert = check_refinement(g, *expand_spmd(capture_spmd(
        spec.dist_fn, spec.mesh_axes, list(spec.in_specs), list(spec.avals),
        list(spec.input_names), device="cpu")))
    assert cert.r_o


def test_default_device_raises_without_a_gpu(monkeypatch):
    """Capture, the certificate replay and the explanation checker run on
    the GPU unless the CPU is asked for: without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    aval = [((4,), torch.float32)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture(torch.neg, aval, ["x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_spmd(torch.neg, {"dp": 2}, [spmd.P("dp")], aval, ["x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay(tapi.build_spec("tp_layer", degree=2, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_explanation({"kind": "certificate", "replay": {}, "outputs": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_env({"r_i": {}, "gd_inputs": [], "consts": {}, "gd_defs": [],
                    "gs_defs": []})

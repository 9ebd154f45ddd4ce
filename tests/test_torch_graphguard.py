"""The JAX package's engine units and lemma properties
(``tests/test_graphguard.py``) held against the port.

Each hand-built e-graph is built twice, once with each package's own
``terms``, ``EGraph`` and lemma set, and saturated the same way. The port
must merge the same classes, extract the same terms (compared as
``pretty`` strings), end with the same node count and fire each lemma as
often as the JAX engine does; on top of that the port's results pass the
JAX test's own assertions. Numbers: the port's ``eval_term`` on the
extracted terms equals the JAX package's within float32's 1e-6 relative
(sums: 1e-6 of the sum of magnitudes, as ``test_torch_engine.py``
holds them), and the lemma soundness checks keep the JAX tests' limits.
The refusals matter most: a ``dus_concat`` or ``scalar_factor`` rewrite
that fired where it must not would be a false certificate.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from repro.core import (RefinementError as JRefinementError,
                        capture as jcapture, capture_spmd as jcapture_spmd,
                        check_refinement as jcheck, expand_spmd as jexpand)
from repro.core import terms as JT
from repro.core.egraph import EGraph as JEGraph
from repro.core.lemmas import _dus_concat as jdus_concat
from repro.core.lemmas import all_lemmas as jall_lemmas
from repro.core.profile import set_optimizations as jset_optimizations
from repro.core.symbolic import AffExpr as JAffExpr
from repro.core.symbolic import ScalarSolver as JScalarSolver
from repro.dist import strategies as JS
from repro.launch.verify import run_case as jrun_case

from repro_torch.core import (RefinementError, capture, capture_spmd,
                              check_refinement, expand_spmd, spmd)
from repro_torch.core import terms as PT
from repro_torch.core.egraph import EGraph
from repro_torch.core.lemmas import _dus_concat as dus_concat
from repro_torch.core.lemmas import all_lemmas
from repro_torch.core.profile import set_optimizations
from repro_torch.core.symbolic import AffExpr, ScalarSolver
from repro_torch.dist import strategies as S
from repro_torch.launch.verify import run_case
from torch_parity import one_thread_module  # noqa: F401 (one thread)

JAX = types.SimpleNamespace(
    T=JT, EGraph=JEGraph, lemmas=jall_lemmas, set_opt=jset_optimizations,
    dus_concat=jdus_concat,
    eval=lambda t, env: np.asarray(JT.eval_term(t, env)))
PORT = types.SimpleNamespace(
    T=PT, EGraph=EGraph, lemmas=all_lemmas, set_opt=set_optimizations,
    dus_concat=dus_concat,
    eval=lambda t, env: PT.eval_term(t, env, device="cpu").numpy())
SIDES = (PORT, JAX)



def _leaf_ok(name):
    return name.endswith("@d")


def _observe(side, eg, roots, fires):
    """What the two engines must agree on: which roots share a class, each
    root's clean and any extraction, the node count and the fires."""
    part = {}
    merged = [part.setdefault(eg.find(c), len(part)) for c in roots]
    out = {"merged": merged, "nodes": eg.n_nodes, "fires": dict(fires)}
    for i, c in enumerate(roots):
        ce, ca = eg.extract_clean(c, _leaf_ok), eg.extract_any(c, _leaf_ok)
        out[f"clean{i}"] = None if ce is None else side.T.pretty(ce, 999)
        out[f"any{i}"] = None if ca is None else \
            (side.T.pretty(ca[0], 999), ca[1])
    return out


def _saturate(side, eg):
    fires = {}
    eg.rebuild()
    eg.saturate(side.lemmas(), fire_counts=fires)
    return fires


def _both(scenario):
    """Run ``scenario(side) -> (eg, roots, fires, extra)`` in each package;
    assert equal observations and return the port's ``extra``."""
    got, want = (scenario(side) for side in SIDES)
    assert _observe(PORT, *got[:3]) == _observe(JAX, *want[:3])
    return got[3], want[3]


def _close_f32(got, want, scale=None):
    """float32 agreement: 1e-6 relative, or 1e-6 of ``scale`` for sums."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if scale is None:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= 1e-6 * np.asarray(scale))


# ---------------------------------------------------------------------------
# hand-built e-graphs
# ---------------------------------------------------------------------------

def _running_example(s):
    T, eg = s.T, s.EGraph()
    A1 = T.tensor("A1@d", (4, 3)); A2 = T.tensor("A2@d", (4, 3))
    B1 = T.tensor("B1@d", (3, 5)); B2 = T.tensor("B2@d", (3, 5))
    cA = eg.add_term(T.tensor("A", (4, 6)))
    eg.merge(cA, eg.add_term(T.concat([A1, A2], 1)))
    cB = eg.add_term(T.tensor("B", (6, 5)))
    eg.merge(cB, eg.add_term(T.concat([B1, B2], 0)))
    eg.rebuild()
    cC = eg.add_term(T.matmul(T.tensor("A", (4, 6)), T.tensor("B", (6, 5))))
    for i, (x, y) in enumerate([(A1, B1), (A2, B2)]):
        eg.merge(eg.add_term(T.tensor(f"C{i}@d", (4, 5))),
                 eg.add_term(T.matmul(x, y)))
    fires = _saturate(s, eg)
    return eg, [cA, cB, cC], fires, eg.extract_clean(cC, _leaf_ok)


def test_paper_running_example():
    ce, jce = _both(_running_example)
    assert ce is not None and ce.is_clean()
    assert ce.op == "add"
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6, 5)).astype(np.float32)
    env = {"C0@d": a[:, :3] @ b[:3], "C1@d": a[:, 3:] @ b[3:]}
    _close_f32(PORT.eval(ce, env), JAX.eval(jce, env))
    np.testing.assert_allclose(PORT.eval(ce, env), a @ b, rtol=1e-5,
                               atol=1e-5)


def _interleaved(s):
    T, eg = s.T, s.EGraph()
    x1 = T.tensor("x1@d", (2, 3)); x2 = T.tensor("x2@d", (2, 3))
    cX = eg.add_term(T.tensor("X", (4, 3)))
    eg.merge(cX, eg.add_term(T.concat([x1, x2], 0)))
    fires = {}
    eg.saturate(s.lemmas(), fire_counts=fires)
    cY = eg.add_term(T.ew1("tanh", T.tensor("X", (4, 3))))
    eg.merge(eg.add_term(T.tensor("Y", (4, 3))), cY)
    eg.rebuild()
    eg.saturate(s.lemmas(), fire_counts=fires)
    return eg, [cX, cY], fires, None


def test_saturate_after_interleaved_merges():
    _both(_interleaved)
    eg, (cX, cY), _, _ = _interleaved(PORT)
    assert eg.extract_clean(cY, _leaf_ok) is None
    assert eg.extract_any(cY, _leaf_ok) is not None
    for c in (cX, cY):
        r = eg.find(c)
        assert eg.find(r) == r and r in eg.classes


def _incremental(s):
    T, eg = s.T, s.EGraph()
    x = T.tensor("x", (2,))
    a = T.tensor("a@d", (2,))
    cQ = eg.add_term(T.concat([x, a], 0))
    before = eg.extract_clean(cQ, _leaf_ok)
    eg.merge(eg.add_term(x), eg.add_term(a))
    eg.rebuild()
    ce = eg.extract_clean(cQ, _leaf_ok)
    try:
        s.set_opt(False)
        sweep = eg.extract_clean(cQ, _leaf_ok)
    finally:
        s.set_opt(True)
    return eg, [cQ], {}, (before, ce, sweep)


def test_incremental_extraction_after_feasibility_merge():
    (before, ce, sweep), (jb, jce, jsweep) = _both(_incremental)
    assert before is None and jb is None
    assert ce is not None and ce.is_clean()
    assert ce == sweep
    assert PT.pretty(ce, 999) == JT.pretty(jce, 999) == \
        JT.pretty(jsweep, 999)


def _nary_add(s):
    T, eg = s.T, s.EGraph()
    a = T.tensor("a@d", (2,)); b = T.tensor("b@d", (2,))
    c = T.tensor("c@d", (2,))
    c1 = eg.add_term(T.add(T.add(a, b), c))
    c2 = eg.add_term(T.add(a, T.add(c, b)))
    c3 = eg.add_term(T.add_n([c, b, a]))
    fires = _saturate(s, eg)
    return eg, [c1, c2, c3], fires, eg.extract_clean(c1, _leaf_ok)


def test_nary_add_normal_form():
    ce, _ = _both(_nary_add)
    eg, (c1, c2, c3), _, _ = _nary_add(PORT)
    assert eg.find(c1) == eg.find(c2) == eg.find(c3)
    assert ce is not None and ce.op == "add"
    assert len(ce.args) == 3


def test_add_n_flattens_and_evaluates():
    outs = []
    for s in SIDES:
        xs = [s.T.tensor(f"x{i}", (3,)) for i in range(5)]
        t = s.T.add_n([s.T.add(xs[0], xs[1]), xs[2], s.T.add_n(xs[3:])])
        assert t.op == "add" and len(t.args) == 5
        assert s.T.add_n([xs[0]]) is xs[0]
        env = {f"x{i}": np.full((3,), float(i)) for i in range(5)}
        val = s.eval(t, env)
        np.testing.assert_allclose(val, np.full((3,), 10.0))
        outs.append((s.T.pretty(t, 999), val.dtype))
    assert outs[0] == outs[1]


def _dus_complete(s):
    T, eg = s.T, s.EGraph()
    zeros = T.broadcast(T.lit(0.0), (4, 3), ())
    u0 = T.tensor("u0@d", (2, 3)); u1 = T.tensor("u1@d", (2, 3))
    full = T.dus(T.dus(zeros, u0, (0, 0)), u1, (2, 0))
    c_full = eg.add_term(full)
    partial = T.dus(zeros, u0, (0, 0))
    c_part = eg.add_term(partial)
    fires = _saturate(s, eg)
    return eg, [c_full, c_part], fires, (
        full, partial, eg.extract_clean(c_full, _leaf_ok),
        eg.extract_clean(c_part, _leaf_ok))


def test_dus_concat_lemma():
    (full, partial, ce, ce_p), (jfull, jpartial, jce, jce_p) = \
        _both(_dus_complete)
    assert ce is not None and ce.op == "concat"
    assert [a.name for a in ce.args] == ["u0@d", "u1@d"]
    if ce_p is not None:
        assert not all(a.op == "tensor" for a in ce_p.args)
        env_p = {"u0@d": 3 * np.ones((2, 3))}
        np.testing.assert_allclose(PORT.eval(ce_p, env_p),
                                   PORT.eval(partial, env_p))
        _close_f32(PORT.eval(ce_p, env_p), JAX.eval(jce_p, env_p))
    env = {"u0@d": np.ones((2, 3)), "u1@d": 2 * np.ones((2, 3))}
    np.testing.assert_allclose(PORT.eval(ce, env), PORT.eval(full, env))
    _close_f32(PORT.eval(ce, env), JAX.eval(jce, env))
    _close_f32(PORT.eval(full, env), JAX.eval(jfull, env))


def _dus_full_write(s):
    T, eg = s.T, s.EGraph()
    zeros = T.broadcast(T.lit(0.0), (2, 4), ())
    u1 = T.tensor("u1@d", (2, 2))
    u_full = T.tensor("uf@d", (2, 4))
    chain = T.dus(T.dus(zeros, u1, (0, 2)), u_full, (0, 0))
    c = eg.add_term(chain)
    fires = _saturate(s, eg)
    return eg, [c], fires, (chain, eg.extract_clean(c, _leaf_ok))


def test_dus_concat_rejects_full_buffer_write():
    (chain, ce), _ = _both(_dus_full_write)
    assert ce is not None and ce.op == "tensor" and ce.name == "uf@d"
    env = {"u1@d": np.ones((2, 2)), "uf@d": 7 * np.ones((2, 4))}
    np.testing.assert_allclose(PORT.eval(ce, env), PORT.eval(chain, env))


def _dus_full_write_mid_chain(s):
    T, eg = s.T, s.EGraph()
    zeros = T.broadcast(T.lit(0.0), (4, 3), ())
    u0 = T.tensor("u0@d", (2, 3)); u1 = T.tensor("u1@d", (2, 3))
    uf = T.tensor("uf@d", (4, 3))
    chain = T.dus(T.dus(T.dus(zeros, u0, (0, 0)), uf, (0, 0)), u1, (2, 0))
    c = eg.add_term(chain)
    eg.rebuild()
    head = next(iter(eg.nodes_of(eg.find(c), "dus")))
    direct = s.dus_concat(eg, head, eg.find(c))
    fires = _saturate(s, eg)
    unsound = eg.find(eg.add_term(T.concat([u0, u1], 0)))
    return eg, [c], fires, (chain, direct, eg.find(c) == unsound,
                            eg.extract_clean(c, _leaf_ok))


def test_dus_concat_refuses_a_full_write_below_the_tiles():
    """A full-buffer write in the middle of a chain makes the tiles below
    it dead: rows [0, 2) hold ``uf``, not ``u0``. Neither engine may
    rewrite the chain as ``concat(u0, u1)``, neither when ``dus_concat``
    is called on the head nor after saturation; what they extract equals
    the chain."""
    (chain, direct, merged, ce), (_, jdirect, jmerged, jce) = \
        _both(_dus_full_write_mid_chain)
    assert direct == [] and jdirect == []
    assert not merged and not jmerged
    env = {"u0@d": np.ones((2, 3)), "u1@d": 2 * np.ones((2, 3)),
           "uf@d": 7 * np.arange(12.0).reshape(4, 3)}
    want = PORT.eval(chain, env)
    np.testing.assert_allclose(want[:2], env["uf@d"][:2])
    assert ce is not None
    np.testing.assert_allclose(PORT.eval(ce, env), want)
    _close_f32(PORT.eval(ce, env), JAX.eval(jce, env))


def _dus_out_of_order(s):
    T, eg = s.T, s.EGraph()
    zeros = T.broadcast(T.lit(0.0), (4, 3), ())
    us = [T.tensor(f"u{i}@d", (1, 3)) for i in range(4)]
    chain = zeros
    for pos in (2, 3, 0, 1):
        chain = T.dus(chain, us[pos], (pos, 0))
    c = eg.add_term(chain)
    fires = _saturate(s, eg)
    return eg, [c], fires, (chain, eg.extract_clean(c, _leaf_ok))


def test_dus_concat_out_of_order_chain_sorts_by_position():
    (chain, ce), (jchain, jce) = _both(_dus_out_of_order)
    assert ce is not None and ce.op == "concat"
    assert [a.name for a in ce.args] == ["u0@d", "u1@d", "u2@d", "u3@d"]
    env = {f"u{i}@d": (i + 1) * np.ones((1, 3)) for i in range(4)}
    np.testing.assert_allclose(PORT.eval(ce, env), PORT.eval(chain, env))
    _close_f32(PORT.eval(chain, env), JAX.eval(jchain, env))


def _dus_offset(s):
    T, eg = s.T, s.EGraph()
    zeros = T.broadcast(T.lit(0.0), (6, 3), ())
    u0 = T.tensor("u0@d", (2, 3)); u1 = T.tensor("u1@d", (2, 3))
    chain = T.dus(T.dus(zeros, u0, (2, 0)), u1, (4, 0))
    c = eg.add_term(chain)
    fires = _saturate(s, eg)
    return eg, [c], fires, (chain, eg.extract_clean(c, _leaf_ok))


def test_dus_concat_bails_on_chain_not_starting_at_zero():
    (chain, ce), (_, jce) = _both(_dus_offset)
    if ce is not None:
        assert not (ce.op == "concat"
                    and all(a.op == "tensor" for a in ce.args))
        env = {"u0@d": np.ones((2, 3)), "u1@d": 2 * np.ones((2, 3))}
        got, want = PORT.eval(ce, env), PORT.eval(chain, env)
        assert got.shape == want.shape == (6, 3)
        np.testing.assert_allclose(got, want)
        _close_f32(got, JAX.eval(jce, env))


def _reduce_reshape(s):
    T, eg = s.T, s.EGraph()
    x = T.tensor("x@d", (4, 3))
    c_seq = eg.add_term(T.reduce_("reduce_sum", T.reshape(x, (12,)), (0,)))
    c_dist = eg.add_term(T.reduce_("reduce_sum", x, (0, 1)))
    fires = _saturate(s, eg)
    return eg, [c_seq, c_dist], fires, (c_seq, c_dist)


def test_reduce_reshape_lemma():
    _both(_reduce_reshape)
    eg, _, fires, (c_seq, c_dist) = _reduce_reshape(PORT)
    assert eg.find(c_seq) == eg.find(c_dist)
    assert fires.get("reduce_reshape")


def _scalar_factor(s, with_scaled=True):
    T, eg = s.T, s.EGraph()
    a = T.tensor("a", ())
    b = T.tensor("b", ())
    four = T.lit(4.0)
    c_whole = eg.add_term(T.ew2("div", T.add(a, b), four))
    if with_scaled:
        eg.merge(eg.add_term(T.tensor("p0@d", ())),
                 eg.add_term(T.ew2("div", a, four)))
        eg.merge(eg.add_term(T.tensor("p1@d", ())),
                 eg.add_term(T.ew2("div", b, four)))
    else:            # the per-addend pieces exist, their scaled nodes not
        eg.merge(eg.add_term(T.tensor("a0@d", ())), eg.add_term(a))
        eg.merge(eg.add_term(T.tensor("b0@d", ())), eg.add_term(b))
    fires = _saturate(s, eg)
    return eg, [c_whole], fires, eg.extract_clean(c_whole, _leaf_ok)


def test_scalar_factor_lemma_constrained():
    ce, jce = _both(_scalar_factor)
    assert ce is not None and ce.op == "add"
    assert _scalar_factor(PORT)[2].get("scalar_factor")
    env = {"p0@d": np.float32(3.0 / 4.0), "p1@d": np.float32(5.0 / 4.0)}
    np.testing.assert_allclose(PORT.eval(ce, env), (3.0 + 5.0) / 4.0)
    _close_f32(PORT.eval(ce, env), JAX.eval(jce, env))
    # the constraint: without the pre-existing scaled nodes the lemma
    # installs no per-addend division, in either engine
    got, want = (_scalar_factor(s, with_scaled=False) for s in SIDES)
    assert _observe(PORT, *got[:3]) == _observe(JAX, *want[:3])
    assert not got[2].get("scalar_factor")


def test_affine_solver():
    for A, Solver in ((AffExpr, ScalarSolver), (JAffExpr, JScalarSolver)):
        s = Solver()
        x = A.var("x")
        assert (x + 1 - x).as_int() == 1
        assert s.eq(2 * x + 2, 2 * (x + 1)) is True
        assert s.eq(x, x + 1) is False
        assert s.eq(x, 2 * x) is None
        s.assume_range("x", 1, None)
        assert s.lt(x, 2 * x) is True
    assert repr(2 * AffExpr.var("x") + 3) == repr(2 * JAffExpr.var("x") + 3)


# ---------------------------------------------------------------------------
# property tests: the same drawn examples through both packages
# ---------------------------------------------------------------------------

def _block_matmul(T, m, k, n, a, b):
    ta, tb = T.tensor("a", a.shape), T.tensor("b", b.shape)
    lhs = T.matmul(ta, tb)
    rhs = T.add(
        T.matmul(T.slice_(ta, (0, 0), (m, k)), T.slice_(tb, (0, 0), (k, n))),
        T.matmul(T.slice_(ta, (0, k), (m, 2 * k)),
                 T.slice_(tb, (k, 0), (2 * k, n))))
    return lhs, rhs


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 6), st.integers(2, 6), st.integers(1, 3),
       st.integers(0, 10**6))
def test_matmul_block_lemma_sound(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, 2 * k)).astype(np.float32)
    b = rng.normal(size=(2 * k, n)).astype(np.float32)
    env = {"a": a, "b": b}
    plhs, prhs = _block_matmul(PT, m, k, n, a, b)
    jlhs, jrhs = _block_matmul(JT, m, k, n, a, b)
    np.testing.assert_allclose(PORT.eval(plhs, env), PORT.eval(prhs, env),
                               rtol=1e-4, atol=1e-4)
    scale = np.abs(a) @ np.abs(b)
    _close_f32(PORT.eval(plhs, env), JAX.eval(jlhs, env), scale)
    _close_f32(PORT.eval(prhs, env), JAX.eval(jrhs, env), scale)


def _merges(s, vals, nmerge, seed):
    eg = s.EGraph()
    cids = [eg.add_term(s.T.tensor(f"x{i}", (abs(v) % 4 + 1,)))
            for i, v in enumerate(vals)]
    rng = np.random.default_rng(seed)
    for _ in range(nmerge):
        i, j = rng.integers(0, len(cids), 2)
        a, b = cids[i], cids[j]
        if eg.info(a).shape == eg.info(b).shape:
            eg.merge(a, b)
    eg.rebuild()
    return eg, cids


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-50, 50), min_size=1, max_size=5),
       st.integers(1, 4), st.integers(0, 10**6))
def test_egraph_merge_find_invariants(vals, nmerge, seed):
    (eg, cids), (jeg, jcids) = (_merges(s, vals, nmerge, seed)
                                for s in SIDES)
    for c in cids:
        r = eg.find(c)
        assert eg.find(r) == r
        assert r in eg.classes
    assert [eg.find(c) for c in cids] == [jeg.find(c) for c in jcids]
    assert sorted(eg.classes) == sorted(jeg.classes)


# ---------------------------------------------------------------------------
# the registered cases through run_case (the port's own capture, CPU)
# ---------------------------------------------------------------------------

def _r_o(cert, pretty):
    return {k: pretty(v, 999) for k, v in cert.r_o.items()}


def _seq_dist(make, bug, device=None):
    kw = {} if device is None else {"device": device}
    return tuple(make(degree=2, bug=bug, **kw))


def test_certificate_numeric_replay_tp():
    """Executable R_o on the port: the expanded multi-rank G_d evaluated
    with the port's eval_term and reconstructed through the certificate
    equals the sequential torch function (the JAX test's 2e-4)."""
    seq_fn, dist_fn, axes, specs, avals, names = \
        _seq_dist(S.STRATEGY_CASES["tp_layer"], None, "cpu")
    gs = capture(seq_fn, avals, names, device="cpu")
    gd, r_i = expand_spmd(capture_spmd(dist_fn, axes, specs, avals, names,
                                       device="cpu"))
    cert = check_refinement(gs, gd, r_i)
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=tuple(a.shape)).astype(np.float32) * 0.3
            for a in avals]
    ref = seq_fn(*[torch.from_numpy(v) for v in vals])
    ref = (ref[0] if isinstance(ref, (tuple, list)) else ref).numpy()
    env = dict(gd.consts)
    for name, spec, v in zip(names, specs, vals):
        ent = tuple(spec) + (None,) * (v.ndim - len(tuple(spec)))
        for r in range(2):
            piece = v
            for d, ax in enumerate(ent):
                if ax is not None:
                    n = v.shape[d] // 2
                    piece = np.take(piece, range(r * n, (r + 1) * n), axis=d)
            env[f"{name}@tp{r}"] = torch.from_numpy(piece)
    for nm, term in gd.defs:
        env[nm] = PT.eval_term(term, env)
    out = cert.reconstruct(env)
    got = list(out.values())[0]
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-4)


BUGS_DETECTED_BY_ERROR = ["rope_offset", "aux_scale", "pad_slice",
                          "sharded_expert", "grad_accum"]


def _raised(make, bug, cap, cap_spmd, expand, check, err, **kw):
    seq_fn, dist_fn, axes, specs, avals, names = _seq_dist(
        make, bug, kw.get("device"))
    gs = cap(seq_fn, avals, names, **kw)
    gd, r_i = expand(cap_spmd(dist_fn, axes, specs, avals, names, **kw))
    with pytest.raises(err) as exc:
        check(gs, gd, r_i)
    return exc.value


@pytest.mark.parametrize("bug", BUGS_DETECTED_BY_ERROR)
def test_bug_detected(bug):
    e = _raised(S.BUG_CASES[bug][0], bug, capture, capture_spmd, expand_spmd,
                check_refinement, RefinementError, device="cpu")
    je = _raised(JS.BUG_CASES[bug][0], bug, jcapture, jcapture_spmd,
                 jexpand, jcheck, JRefinementError)
    assert "operator" in str(e) or "output" in str(e)
    assert (e.op_index, e.op_name, e.out_name) == \
        (je.op_index, je.op_name, je.out_name)


def test_bug5_unexpected_relation():
    (expr_ok,) = run_case("ln_grad", quiet=True, device="cpu").r_o.values()
    seq_fn, dist_fn, axes, specs, avals, names = _seq_dist(
        S.BUG_CASES["ln_no_allreduce"][0], "ln_no_allreduce", "cpu")
    gs = capture(seq_fn, avals, names, device="cpu")
    gd, r_i = expand_spmd(capture_spmd(dist_fn, axes, specs, avals, names,
                                       device="cpu"))
    (expr_bug,) = check_refinement(gs, gd, r_i).r_o.values()
    assert expr_ok.op == "tensor"
    assert expr_bug.op == "add", expr_bug
    jbug = jrun_case("ln_grad", bug="ln_no_allreduce", quiet=True)
    (jexpr,) = jbug.r_o.values()
    assert PT.pretty(expr_bug, 999) == JT.pretty(jexpr, 999)


def test_certificate_stats_phases():
    cert = run_case("tp_layer", quiet=True, device="cpu")
    jcert = jrun_case("tp_layer", quiet=True)
    for phase in ("saturate", "frontier", "extract"):
        assert phase in cert.stats["phase_s"], cert.stats["phase_s"]
        assert cert.stats["phase_s"][phase] >= 0.0
    assert cert.stats["counters"].get("lemma_calls", 0) > 0
    assert "opt" in cert.stats and "lemma_fires" in cert.stats
    assert set(cert.stats["phase_s"]) == set(jcert.stats["phase_s"])
    for k in ("opt", "lemma_fires", "lemmas", "counters"):
        assert cert.stats[k] == jcert.stats[k], k


def test_optimizations_behaviour_preserving():
    seq_fn, dist_fn, axes, specs, avals, names = _seq_dist(
        S.BUG_CASES["pad_slice"][0], "pad_slice", "cpu")
    gs = capture(seq_fn, avals, names, device="cpu")
    gd, r_i = expand_spmd(capture_spmd(dist_fn, axes, specs, avals, names,
                                       device="cpu"))
    try:
        set_optimizations(True)
        cert_on = run_case("sp_moe", degree=4, quiet=True, device="cpu")
        set_optimizations(False)
        cert_off = run_case("sp_moe", degree=4, quiet=True, device="cpu")
        assert cert_on.r_o == cert_off.r_o
        assert cert_on.relation == cert_off.relation
        errs = []
        for flag in (True, False):
            set_optimizations(flag)
            with pytest.raises(RefinementError) as exc:
                check_refinement(gs, gd, r_i)
            errs.append((exc.value.op_index, exc.value.op_name,
                         exc.value.out_name))
        assert errs[0] == errs[1]
    finally:
        set_optimizations(True)
    jcert = jrun_case("sp_moe", degree=4, quiet=True)
    assert _r_o(cert_on, PT.pretty) == _r_o(jcert, JT.pretty)
    with pytest.raises(JRefinementError) as jexc:
        jrun_case("sp_pad", bug="pad_slice", quiet=True)
    assert errs[0] == (jexc.value.op_index, jexc.value.op_name,
                       jexc.value.out_name)


def test_scaling_with_degree():
    for deg in (2, 4):
        cert = run_case("sp_moe", degree=deg, quiet=True, device="cpu")
        jcert = jrun_case("sp_moe", degree=deg, quiet=True)
        assert cert.r_o
        assert _r_o(cert, PT.pretty) == _r_o(jcert, JT.pretty)
        assert cert.stats["lemma_fires"] == jcert.stats["lemma_fires"]


def test_spmd_expansion_semantics():
    """all_gather / psum / psum_scatter expand to numpy's semantics, and
    every output equals the JAX expansion's on the same input."""
    def dist(x):
        g = spmd.all_gather(x, "tp", axis=0, tiled=True)
        s = spmd.psum(x, "tp")
        rs = spmd.psum_scatter(g, "tp", scatter_dimension=0, tiled=True)
        return g, s, rs

    def jdist(x):
        g = jax.lax.all_gather(x, "tp", axis=0, tiled=True)
        s = jax.lax.psum(x, "tp")
        rs = jax.lax.psum_scatter(g, "tp", scatter_dimension=0, tiled=True)
        return g, s, rs

    gd, _ = expand_spmd(capture_spmd(dist, {"tp": 2},
                                     [spmd.PartitionSpec("tp", None)],
                                     [((4, 3), torch.float32)], ["x"],
                                     device="cpu"))
    jgd, _ = jexpand(jcapture_spmd(
        jdist, {"tp": 2}, [JP("tp", None)],
        [jax.ShapeDtypeStruct((4, 3), jnp.float32)], ["x"]))
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    outs = []
    for g, ev in ((gd, PORT.eval), (jgd, JAX.eval)):
        env = {"x@tp0": x[:2], "x@tp1": x[2:]}
        env.update(g.consts)
        for nm, term in g.defs:
            env[nm] = ev(term, env)
        outs.append([np.asarray(env[o]) for o in g.outputs])
    got, want = outs
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got[0], x, rtol=1e-6)
    np.testing.assert_allclose(got[2], x[:2] + x[2:], rtol=1e-6)
    np.testing.assert_allclose(got[4], (x + x)[:2], rtol=1e-6)
    for a, b in zip(got, want):
        _close_f32(a, b)

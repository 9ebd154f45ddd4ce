"""Proof provenance: explainable certificates and failure frontiers.

With ``EGraph(explain=True)`` every union is journaled as an edge
``(root_a, root_b, reason)`` between its two pre-union roots (egg-style
explanations, Flatt et al.): each union joins exactly two components of the
edge graph, so two class ids are union-find-equal iff an edge path connects
them.  This module walks those paths to produce two artifacts:

* **Certificate chains** — for each G_s output, the step-by-step sequence of
  term rewrites ``seq_out = t_1 = t_2 = ... = R_o(dist_out)`` with the lemma
  (or congruence/definition) justifying each step.  Ids are quotiented by
  their *rendered term* (the creating e-node, recursively) so the chain is a
  path over distinct expressions, and BFS with canonically sorted adjacency
  makes it deterministic for a given set of recorded unions.
* **Failure frontiers** — when refinement gets stuck, the nearest proven
  equivalences around the stuck operator plus the lemmas that fired while
  processing it but did not close the goal, rendered as a narrative.

Every explanation carries a ``replay`` section (both graphs' defining
equations, the input relation, and const values) so ``check_explanation``
can re-validate the chain *outside* the e-graph: it evaluates both graphs on
seeded random inputs and checks each step's lhs/rhs numerically plus the
chain's connectivity — a tampered or fabricated step fails.  That makes the
explanation a machine-checkable proof object rather than a log.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .terms import Term, eval_term, pretty

SCHEMA = 1


# -- term (de)serialization ---------------------------------------------------

def term_to_obj(t: Term) -> dict:
    """JSON-safe structural form of a Term (attrs values are ints, floats,
    strings, or int tuples — tuples become lists in JSON and are restored
    by :func:`term_from_obj`)."""
    return {
        "op": t.op,
        "attrs": [[k, v] for k, v in t.attrs],
        "args": [term_to_obj(a) for a in t.args],
        "shape": list(t.shape),
        "dtype": t.dtype,
    }


def _tupled(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tupled(x) for x in v)
    return v


def term_from_obj(o: dict) -> Term:
    """Rebuild a hash-consed Term from :func:`term_to_obj` output (accepts
    both in-memory and JSON-round-tripped forms)."""
    attrs = tuple((k, _tupled(v)) for k, v in o["attrs"])
    args = tuple(term_from_obj(a) for a in o["args"])
    return Term(o["op"], args, attrs, tuple(o["shape"]), o["dtype"])


def _reason_obj(reason: Optional[tuple]) -> dict:
    if reason is None:
        return {"kind": "merge"}
    kind = reason[0]
    if kind == "congruence":
        return {"kind": "congruence", "op": reason[1]}
    if len(reason) > 1:
        return {"kind": kind, "name": reason[1]}
    return {"kind": kind}


def _reason_key(reason: Optional[tuple]) -> tuple:
    return ("merge",) if reason is None else tuple(str(x) for x in reason)


def reason_label(robj: dict) -> str:
    """One-token human label for a step justification."""
    kind = robj.get("kind", "merge")
    detail = robj.get("name") or robj.get("op")
    return f"{kind} {detail}" if detail else kind


# -- proof-forest walking -----------------------------------------------------

def term_of(eg, cid: int, memo: dict) -> Term:
    """Render class ``cid`` as the Term built from its creating e-node,
    recursively (children ids are strictly smaller, so this is acyclic)."""
    t = memo.get(cid)
    if t is None:
        node, shape, dtype = eg.node_meta[cid]
        args = tuple(term_of(eg, c, memo) for c in node.children)
        t = Term(node.op, args, node.attrs, shape, dtype)
        memo[cid] = t
    return t


def edge_adjacency(eg) -> dict:
    """Quotient the journaled union edges by rendered term.

    Returns ``{Term: [(Term, reason_obj), ...]}`` with adjacency lists
    sorted by (neighbour sort_key, reason) and deduped, so BFS over it is
    deterministic for a given edge *set* regardless of recording order."""
    memo: dict = {}
    raw: dict = {}
    for a, b, reason in eg.explain_edges:
        u, v = term_of(eg, a, memo), term_of(eg, b, memo)
        if u is v:
            continue
        raw.setdefault(u, {})[(v.sort_key(), _reason_key(reason))] = (v, reason)
        raw.setdefault(v, {})[(u.sort_key(), _reason_key(reason))] = (u, reason)
    adj: dict = {}
    for u, nbrs in raw.items():
        adj[u] = [(v, _reason_obj(r))
                  for _k, (v, r) in sorted(nbrs.items(), key=lambda kv: kv[0])]
    return adj


def _bfs(adj: dict, start: Term):
    """Full BFS from ``start``: returns ({term: (prev, reason)}, {term: dist}).
    Deterministic given the sorted adjacency."""
    prev: dict = {start: None}
    dist: dict = {start: 0}
    q = deque([start])
    while q:
        u = q.popleft()
        for v, reason in adj.get(u, ()):
            if v not in prev:
                prev[v] = (u, reason)
                dist[v] = dist[u] + 1
                q.append(v)
    return prev, dist


def certificate_chain(eg, adj: dict, out_name: str, out_shape, out_dtype,
                      r_o_term: Term, leaf_ok) -> list:
    """The step list proving ``out_name ≡ r_o_term``.

    Walks the proof forest from the G_s output tensor to the first term
    (in BFS order) that is clean over allowed leaves — preferring the exact
    R_o term — then appends the final ``extract`` step when the endpoint is
    not literally R_o (extraction combines best sub-renderings across
    classes, so no single journaled vertex need equal it).  Every step,
    including ``extract``, is numerically validated by the replay checker.
    """
    from .terms import tensor as mk_tensor
    start = mk_tensor(out_name, out_shape, out_dtype)
    prev, dist = _bfs(adj, start)

    def clean_over(t: Term) -> bool:
        return t.is_clean() and all(
            l.op == "lit" or leaf_ok(l.name) for l in t.leaves())

    end = None
    if r_o_term in prev:
        end = r_o_term
    else:
        cands = [t for t in prev if t is not start and clean_over(t)]
        if cands:
            end = min(cands, key=lambda t: (dist[t], t.sort_key()))
    if end is None:
        # degenerate: no journaled vertex is clean — chain is the single
        # extraction step (still replay-checked numerically)
        path = [start]
    else:
        path = [end]
        while prev[path[-1]] is not None:
            u, reason = prev[path[-1]]
            path.append(u)
        path.reverse()

    steps = []
    for i in range(len(path) - 1):
        u, v = path[i], path[i + 1]
        _pu, reason = prev[v]
        steps.append(_step(u, v, reason))
    if path[-1] is not r_o_term:
        steps.append(_step(path[-1], r_o_term, {"kind": "extract"}))
    return steps


def _step(lhs: Term, rhs: Term, reason: dict) -> dict:
    return {"lhs": term_to_obj(lhs), "rhs": term_to_obj(rhs),
            "lhs_str": pretty(lhs, 999), "rhs_str": pretty(rhs, 999),
            "reason": reason}


# -- building explanations ----------------------------------------------------

def build_replay(gg) -> dict:
    """Everything the replay checker needs to re-validate a chain without
    the e-graph: both graphs' defs, the input relation, and const values."""
    gs, gd = gg.gs, gg.gd
    consts = {}
    for g in (gs, gd):
        for n, v in g.consts.items():
            a = np.asarray(_host(v))
            consts[n] = {"shape": list(a.shape), "dtype": str(a.dtype),
                         "data": a.tolist()}
    return {
        "gd_inputs": [{"name": n, "shape": list(gd.shapes[n]),
                       "dtype": gd.dtypes[n]} for n in gd.inputs],
        "gd_defs": [[n, term_to_obj(t)] for n, t in gd.defs],
        "gs_defs": [[n, term_to_obj(t)] for n, t in gs.defs],
        "r_i": {n: [term_to_obj(e) for e in exprs]
                for n, exprs in sorted(gg.r_i.items())},
        "consts": consts,
    }


def build_certificate_explanation(gg, r_o: dict) -> dict:
    """Lemma chains for every R_o entry plus the replay payload."""
    eg = gg.eg
    adj = edge_adjacency(eg)
    out_names = set(gg.gd.outputs)
    leaf_ok = lambda n: n in out_names or n in gg.gd.consts
    outputs = {}
    lemmas_used: set = set()
    total = 0
    for o in sorted(r_o):
        shape = gg.gs.shapes.get(o, r_o[o].shape)
        dtype = gg.gs.dtypes.get(o, r_o[o].dtype)
        steps = certificate_chain(eg, adj, o, shape, dtype, r_o[o], leaf_ok)
        for s in steps:
            if s["reason"].get("kind") == "lemma":
                lemmas_used.add(s["reason"]["name"])
        outputs[o] = {"n_steps": len(steps), "steps": steps,
                      "target": pretty(r_o[o], 999)}
        total += len(steps)
    return {
        "kind": "certificate",
        "schema": SCHEMA,
        "outputs": outputs,
        "lemmas_used": sorted(lemmas_used),
        "total_steps": total,
        "replay": build_replay(gg),
    }


def build_failure_frontier(gg, op_index: int, op_name: str, out_name: str,
                           input_mappings: dict, diagnostic,
                           fired: dict) -> dict:
    """The frontier of failure around a stuck operator: nearest proven
    equivalences, lemmas that fired on this op without closing it, and the
    best non-clean candidate, as a step-by-step narrative."""
    proven = list(gg.relation.items())[-6:]
    fired = {k: fired[k] for k in sorted(fired) if fired[k] > 0}
    lines = [
        f"refinement stuck at G_s op #{op_index} `{op_name}` "
        f"(output `{out_name}`)",
    ]
    if proven:
        lines.append("frontier of proven equivalences nearest the stuck op:")
        for name, t in proven:
            lines.append(f"  {name} = {pretty(t, 999)}")
    if input_mappings:
        lines.append("input mappings at the frontier:")
        for k, v in input_mappings.items():
            lines.append(f"  {k} = {pretty(v, 999)}")
    if fired:
        lines.append("lemmas that fired on this op but did not close it: "
                     + ", ".join(f"{k} x{v}" for k, v in fired.items()))
    else:
        lines.append("no lemma fired while processing this op")
    if diagnostic is not None:
        expr, n_unclean = diagnostic
        lines.append(f"nearest candidate needs {n_unclean} non-clean op(s): "
                     f"{pretty(expr, 999)}")
    return {
        "kind": "failure_frontier",
        "schema": SCHEMA,
        "stuck_op": {"op_index": op_index, "op_name": op_name,
                     "out_name": out_name},
        "proven": {name: pretty(t, 999) for name, t in proven},
        "input_mappings": {k: pretty(v, 999)
                           for k, v in input_mappings.items()
                           if v is not None},
        "fired_no_close": fired,
        "diagnostic": None if diagnostic is None else
        {"expr": pretty(diagnostic[0], 999), "n_unclean": diagnostic[1]},
        "narrative": lines,
    }


# -- independent replay checking ----------------------------------------------

def _rand(rng, shape, dtype: str):
    shape = tuple(shape)
    if dtype == "i":
        # small non-negative ints: safe as gather indices into any table
        return rng.integers(0, 2, size=shape, dtype=np.int64)
    if dtype == "b":
        return rng.integers(0, 2, size=shape).astype(bool)
    return rng.standard_normal(shape)


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _values_close(a, b) -> bool:
    a, b = np.asarray(_host(a)), np.asarray(_host(b))
    if a.shape != b.shape:
        return False
    if a.dtype.kind in "ib" and b.dtype.kind in "ib":
        return bool(np.array_equal(a, b))
    return bool(np.allclose(np.asarray(a, dtype=np.float64),
                            np.asarray(b, dtype=np.float64),
                            rtol=1e-6, atol=1e-8))


def _alias_leaves(a: Term, b: Term, alias: dict):
    """Record that structurally-corresponding tensor leaves of two R_i
    expressions must carry equal values (replicated shards)."""
    if a.op == "tensor" and b.op == "tensor":
        ca, cb = _canon_name(a.name, alias), _canon_name(b.name, alias)
        if ca != cb:
            alias[cb] = ca
    elif a.op == b.op and len(a.args) == len(b.args):
        for x, y in zip(a.args, b.args):
            _alias_leaves(x, y, alias)


def _canon_name(n: str, alias: dict) -> str:
    while n in alias:
        n = alias[n]
    return n


def replay_env(replay: dict, seed: int = 0, device=None) -> dict:
    """Evaluate both graphs on seeded random G_d inputs; returns the full
    ``name -> tensor`` environment every chain term can be read in. The
    inputs are drawn with numpy (the JAX package's draws) and evaluated
    with torch on ``device`` (``cuda`` unless ``"cpu"`` is asked for).

    A G_s input with several R_i expressions (one per replica coordinate)
    constrains corresponding G_d leaves to be equal — replicated shards are
    generated once and shared, so the random environment actually satisfies
    R_i."""
    env: dict = {}
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    alias: dict = {}
    for n, objs in replay["r_i"].items():
        if len(objs) > 1:
            t0 = term_from_obj(objs[0])
            for o in objs[1:]:
                _alias_leaves(t0, term_from_obj(o), alias)
    for spec in replay["gd_inputs"]:
        c = _canon_name(spec["name"], alias)
        if c not in env:
            env[c] = torch.from_numpy(
                _rand(rng, spec["shape"], spec["dtype"])).to(dev)
        env[spec["name"]] = env[c]
    for n, d in replay["consts"].items():
        env[n] = torch.from_numpy(np.asarray(
            d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])).to(dev)
    for n, t in replay["gd_defs"]:
        env[n] = eval_term(term_from_obj(t), env, dev)
    for n, objs in replay["r_i"].items():
        if objs and n not in env:
            env[n] = eval_term(term_from_obj(objs[0]), env, dev)
    for n, t in replay["gs_defs"]:
        env[n] = eval_term(term_from_obj(t), env, dev)
    return env


def check_explanation(expl: dict, seed: int = 0, device=None) -> dict:
    """Re-validate a certificate explanation outside the e-graph.

    Checks, per output chain: (1) the chain starts at the output tensor,
    (2) consecutive steps connect (step i's rhs is step i+1's lhs), and
    (3) every step's lhs and rhs evaluate to the same value on seeded
    random inputs on ``device`` (``cuda`` unless ``"cpu"`` is asked for).
    Returns ``{"ok", "checked_steps", "failures"}`` — any tampered,
    reordered, or fabricated step lands in ``failures``."""
    failures: list = []
    checked = 0
    if expl.get("kind") != "certificate":
        return {"ok": False, "checked_steps": 0,
                "failures": ["not a certificate explanation"]}
    device = resolve_device(device)    # no card and no "cpu": raise
    try:
        env = replay_env(expl["replay"], seed=seed, device=device)
    except Exception as e:  # noqa: BLE001 - any replay failure is a finding
        return {"ok": False, "checked_steps": 0,
                "failures": [f"replay environment failed: {e!r}"]}
    for o, entry in sorted(expl["outputs"].items()):
        steps = entry["steps"]
        if not steps:
            failures.append(f"{o}: empty chain")
            continue
        first = term_from_obj(steps[0]["lhs"])
        if not (first.op == "tensor" and first.name == o):
            failures.append(f"{o}: chain does not start at the output tensor")
        for i, s in enumerate(steps):
            lhs, rhs = term_from_obj(s["lhs"]), term_from_obj(s["rhs"])
            if i + 1 < len(steps) \
                    and rhs is not term_from_obj(steps[i + 1]["lhs"]):
                failures.append(f"{o}: step {i} rhs != step {i + 1} lhs "
                                "(broken chain)")
            try:
                lv, rv = eval_term(lhs, env), eval_term(rhs, env)
            except Exception as e:  # noqa: BLE001
                failures.append(f"{o}: step {i} failed to evaluate: {e!r}")
                continue
            checked += 1
            if not _values_close(lv, rv):
                failures.append(
                    f"{o}: step {i} ({reason_label(s['reason'])}) does not "
                    f"hold numerically: {s['lhs_str']} != {s['rhs_str']}")
    return {"ok": not failures, "checked_steps": checked,
            "failures": failures}


# -- aggregation + rendering --------------------------------------------------

def aggregate_explanations(reports: dict) -> Optional[dict]:
    """Roll nested per-obligation explanations up into a family-report
    summary (counts + lemma sets; the full chains stay on the nested
    reports).  Returns None when no nested report carries one."""
    per: dict = {}
    total = 0
    for key in sorted(reports):
        rep = reports[key]
        expl = rep.get("explanation") if isinstance(rep, dict) else None
        if not expl:
            continue
        if expl.get("kind") == "certificate":
            per[key] = {
                "kind": "certificate",
                "steps": {o: e["n_steps"]
                          for o, e in sorted(expl["outputs"].items())},
                "lemmas_used": expl.get("lemmas_used", []),
            }
            total += expl.get("total_steps", 0)
        else:
            per[key] = {
                "kind": expl.get("kind"),
                "stuck_op": expl.get("stuck_op"),
                "fired_no_close": sorted(expl.get("fired_no_close") or {}),
            }
    if not per:
        return None
    return {"kind": "summary", "schema": SCHEMA,
            "per_obligation": per, "total_steps": total}


def explanation_steps(expl: Optional[dict]) -> int:
    """Total chain steps in any explanation shape (0 when absent)."""
    if not expl:
        return 0
    return int(expl.get("total_steps", 0))


def render_narrative(expl: dict) -> list:
    """Human-readable lines for an explanation (any kind)."""
    if expl.get("kind") == "failure_frontier":
        return list(expl.get("narrative", ()))
    if expl.get("kind") == "summary":
        lines = []
        for key, entry in sorted(expl.get("per_obligation", {}).items()):
            if entry.get("kind") == "certificate":
                steps = ", ".join(f"{o}: {n} step(s)"
                                  for o, n in sorted(entry["steps"].items()))
                lem = ", ".join(entry.get("lemmas_used") or ()) or "-"
                lines.append(f"{key}: proved ({steps}; lemmas: {lem})")
            else:
                stuck = entry.get("stuck_op") or {}
                fired = ", ".join(entry.get("fired_no_close") or ()) or "-"
                lines.append(
                    f"{key}: STUCK at op #{stuck.get('op_index')} "
                    f"`{stuck.get('op_name')}` (fired, did not close: "
                    f"{fired})")
        lines.append(f"total chain steps: {expl.get('total_steps', 0)}")
        return lines
    lines = []
    for o, entry in sorted(expl.get("outputs", {}).items()):
        lines.append(f"output `{o}`: {entry['n_steps']} step(s)")
        cur = None
        for s in entry["steps"]:
            if cur is None:
                lines.append(f"  {s['lhs_str']}")
            lines.append(f"    = [{reason_label(s['reason'])}] {s['rhs_str']}")
            cur = s["rhs_str"]
    if expl.get("lemmas_used"):
        lines.append("lemmas used: " + ", ".join(expl["lemmas_used"]))
    return lines

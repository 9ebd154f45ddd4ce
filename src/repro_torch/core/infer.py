"""GraphGuard relation inference (paper §4, Listings 1–3).

``check_refinement(gs, gd, r_i)`` processes each G_s operator in topological
order, maintaining a single e-graph in which every G_s tensor's class is
merged with its defining expression and (transitively) with equivalent
expressions over G_d tensors. Per operator it:

  1. installs the operator's defining equation (step 1 of Listing 2 — input
     substitution is implicit: inputs share classes with their mappings),
  2. saturates the lemma set (step 2),
  3. grows the related-subgraph frontier of G_d and installs the defining
     equations of newly-eligible G_d nodes (step 3, optimized per Listing 3),
  4. extracts a *clean* expression over G_d tensors for each output
     (step 4); failure raises ``RefinementError`` naming the operator —
     the paper's bug-localization output — and attaches the best non-clean
     candidate expression as a diagnostic (our extension: it shows *what
     computation would be required*, e.g. a leftover ``div`` for scaling
     bugs).

The result is a ``Certificate`` holding the complete clean output relation
R_o; ``Certificate.reconstruct`` replays it numerically (certificates are
executable — paper §3.1 'the user can use a complete R_o to translate
outputs from a deployed G_d').

Frontier growth (step 3) is indexed: each pending G_d def carries an
unmet-dependency count, and a map from leaf tensor name to waiting defs
lets a newly related tensor enqueue exactly the defs it unblocks —
O(new names) per call instead of rescanning every pending def.
``Certificate.stats`` carries per-phase wall time (saturate / rebuild /
frontier / extract) and engine counters from ``repro.core.profile``.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from .capture import Graph
from .egraph import EGraph, EGraphLimit
from .explain import build_certificate_explanation, build_failure_frontier
from .lemmas import all_lemmas
from .profile import CONFIG, Profile, explain_enabled
from .terms import Term, eval_term, pretty


def is_dist_name(name: str) -> bool:
    """True for per-rank tensor names (carrying a ``@rank`` tag)."""
    return "@" in name


@dataclass
class Certificate:
    """A complete clean output relation R_o (soundness certificate)."""
    r_o: dict                      # G_s output name -> clean Term over G_d
    relation: dict                 # all G_s tensors -> clean Term (R)
    stats: dict
    # proof provenance (``explain=True`` only); deliberately NOT part of
    # ``to_json`` so certificate payloads stay byte-identical with it off
    explanation: Optional[dict] = field(default=None, repr=False,
                                        compare=False)

    def reconstruct(self, gd_env: dict, device=None) -> dict:
        """Rebuild G_s outputs from G_d tensor values (executable R_o), as
        torch tensors on ``device`` or on the device of ``gd_env``'s."""
        return {name: eval_term(expr, gd_env, device)
                for name, expr in self.r_o.items()}

    def to_json(self) -> dict:
        """JSON-safe view: full-depth stringified R_o + the stats dict.

        The ``repro.api`` Report layer builds on this; r_o strings use
        unbounded pretty-printing so certificates compare byte-identical
        across engine configurations and processes.
        """
        return {
            "r_o": {k: pretty(v, 999) for k, v in self.r_o.items()},
            "stats": self.stats,
        }


class RefinementError(Exception):
    """G_d does not (provably) refine G_s. Carries localization info."""

    def __init__(self, op_index: int, op_name: str, out_name: str,
                 input_mappings: dict, diagnostic: Optional[tuple],
                 message: str = ""):
        self.op_index = op_index
        self.op_name = op_name
        self.out_name = out_name
        self.input_mappings = input_mappings
        self.diagnostic = diagnostic
        self.explanation = None     # failure frontier (``explain=True`` only)
        lines = [
            f"refinement failed at G_s operator #{op_index} "
            f"`{op_name}` (output `{out_name}`)",
        ]
        if input_mappings:
            lines.append("input mappings found so far:")
            for k, v in input_mappings.items():
                lines.append(f"  {k} = {v}")
        if diagnostic is not None:
            expr, n_unclean = diagnostic
            lines.append(
                f"nearest candidate needs {n_unclean} non-clean op(s): {expr}")
            lines.append(
                "  -> reconstructing this output requires real computation; "
                "inspect the operators above for the missing/incorrect "
                "transformation (paper §6.2 debugging workflow)")
        if message:
            lines.append(message)
        super().__init__("\n".join(lines))

    def payload(self) -> dict:
        """JSON-safe localization payload (the paper's bug report, typed)."""
        out = {
            "op_index": self.op_index,
            "op_name": self.op_name,
            "out_name": self.out_name,
            "input_mappings": {k: pretty(v, 999)
                               for k, v in self.input_mappings.items()
                               if v is not None},
        }
        if self.diagnostic is not None:
            expr, n_unclean = self.diagnostic
            out["diagnostic"] = {"expr": pretty(expr, 999),
                                 "n_unclean": n_unclean}
        return out


@dataclass
class GraphGuard:
    """Iterative relation inference over (G_s, G_d, R_i)."""
    gs: Graph
    gd: Graph
    r_i: dict                       # G_s input name -> [Terms over G_d inputs]
    max_nodes: int = 400_000
    collect_lemma_stats: bool = True
    explain: Optional[bool] = None  # None -> GRAPHGUARD_EXPLAIN env default

    def __post_init__(self):
        self.explain = explain_enabled(self.explain)
        self.eg = EGraph(max_nodes=self.max_nodes, explain=self.explain)
        self.lemmas = all_lemmas()
        self.fire_counts: dict = {}
        self.profile = Profile()
        self.eg.profile = self.profile
        self.related: set = set()          # T_rel: related G_d tensor names
        self.gd_pending = list(self.gd.defs)  # G_d defs not yet installed
        self.relation: dict = {}           # G_s tensor -> clean Term
        # frontier index: per-def unmet-dependency counts + leaf -> waiters
        self._unmet: dict = {}
        self._waiters: dict = defaultdict(list)
        self._ready: deque = deque()
        self._installed: set = set()
        if CONFIG.indexed_frontier:
            self._init_frontier_index()

    # -- setup ---------------------------------------------------------------
    def _init_frontier_index(self):
        for entry in self.gd_pending:
            name, term = entry
            deps = {l.name for l in term.leaves()
                    if l.op == "tensor" and l.name not in self.gd.consts
                    and l.name not in self.related}
            if not deps:
                self._ready.append(entry)
            else:
                self._unmet[name] = len(deps)
                for d in deps:
                    self._waiters[d].append(entry)

    def _mark_name(self, name: str):
        """Add a G_d tensor to T_rel, unblocking defs that waited on it."""
        if name in self.related:
            return
        self.related.add(name)
        if not CONFIG.indexed_frontier:
            return
        for entry in self._waiters.pop(name, ()):
            left = self._unmet[entry[0]] = self._unmet[entry[0]] - 1
            if left == 0:
                self._ready.append(entry)

    def _install_inputs(self):
        with obs_trace.span("install_inputs", cat="engine"):
            self._install_inputs_inner()

    def _install_inputs_inner(self):
        xp = self.explain
        for name, exprs in self.r_i.items():
            c_s = self.eg.add_term(self.gs.tensor(name))
            for e in exprs:
                self.eg.merge(c_s, self.eg.add_term(e),
                              ("input", name) if xp else None)
                for leaf in e.leaves():
                    if leaf.op == "tensor":
                        self._mark_name(leaf.name)
            if exprs:
                self.relation[name] = exprs[0]
        # consts: value-match G_s consts to G_d consts (rank-replicated);
        # both are host numpy arrays, so the match is exact on any device
        matched = 0
        for sname, sval in self.gs.consts.items():
            c_s = self.eg.add_term(self.gs.tensor(sname))
            for dname, dval in self.gd.consts.items():
                if sval.shape == dval.shape and sval.dtype == dval.dtype \
                        and np.array_equal(sval, dval):
                    self.eg.merge(c_s, self.eg.add_term(self.gd.tensor(dname)),
                                  ("const", sname) if xp else None)
                    self._mark_name(dname)
                    matched += 1
        self.eg.rebuild()

    # -- frontier (Listing 3) -------------------------------------------------
    def _install_def(self, name: str, term: Term):
        c_out = self.eg.add_term(self.gd.tensor(name))
        self.eg.merge(c_out, self.eg.add_term(term),
                      ("dist_def", name) if self.explain else None)
        for l in term.leaves():
            if l.op == "tensor":
                self._mark_name(l.name)
        self._mark_name(name)

    def _grow_frontier(self) -> bool:
        """Install defining equations of G_d nodes whose inputs are related."""
        t0 = time.perf_counter()
        if CONFIG.indexed_frontier:
            REGISTRY.histogram("engine.frontier_ready").observe(
                len(self._ready))
            grew = False
            while self._ready:
                name, term = self._ready.popleft()
                if name in self._installed:
                    continue
                self._installed.add(name)
                self._install_def(name, term)
                grew = True
        else:
            grew = self._grow_frontier_scan()
        t1 = time.perf_counter()
        self.profile.add_time("frontier", t1 - t0)
        tracer = obs_trace.current()
        if tracer is not None and grew:
            tracer.span_from("frontier", t0, t1)
        if grew:
            self.eg.rebuild()
        return grew

    def _grow_frontier_scan(self) -> bool:
        """Baseline O(pending defs) rescan (CONFIG.indexed_frontier off)."""
        grew = False
        still = []
        for name, term in self.gd_pending:
            leaves = [l.name for l in term.leaves() if l.op == "tensor"]
            if all(l in self.related or l in self.gd.consts for l in leaves):
                self._install_def(name, term)
                grew = True
            else:
                still.append((name, term))
        self.gd_pending = still
        return grew

    def _mark_related(self, expr: Term):
        for leaf in expr.leaves():
            if leaf.op == "tensor":
                self._mark_name(leaf.name)

    # -- timed engine wrappers -------------------------------------------------
    def _saturate(self):
        t0 = time.perf_counter()
        with obs_trace.span("saturate", cat="engine"):
            self.eg.saturate(
                self.lemmas,
                fire_counts=self.fire_counts if self.collect_lemma_stats
                else None)
        # note: includes rebuild time, which the egraph also reports separately
        self.profile.add_time("saturate", time.perf_counter() - t0)

    def _extract(self, cid, leaf_ok):
        t0 = time.perf_counter()
        with obs_trace.span("extract", cat="engine"):
            out = self.eg.extract_clean(self.eg.find(cid), leaf_ok)
        self.profile.add_time("extract", time.perf_counter() - t0)
        return out

    # -- main loop (Listing 1) --------------------------------------------------
    def run(self) -> Certificate:
        t0 = time.perf_counter()
        self._install_inputs()
        self._grow_frontier()
        leaf_ok = lambda n: is_dist_name(n) or n in self.gd.consts

        for i, (out_name, term) in enumerate(self.gs.defs):
            with obs_trace.span(f"op:{out_name}", cat="engine",
                                op=term.op, index=i):
                # fire counts at op start: the delta on failure is the
                # fired-but-did-not-close set for the failure frontier
                fires_at_op = dict(self.fire_counts) if self.explain else None
                c_out = self.eg.add_term(self.gs.tensor(out_name))
                self.eg.merge(c_out, self.eg.add_term(term),
                              ("seq_def", out_name) if self.explain else None)
                self.eg.rebuild()
                # saturate + frontier to fixpoint (Listing 3 loop);
                # extraction is the expensive step, so frontier growth is
                # driven to fixpoint between extractions rather than
                # per-iteration.
                ce = None
                for _ in range(6):
                    for _ in range(10):
                        self._saturate()
                        if not self._grow_frontier():
                            break
                    ce = self._extract(c_out, leaf_ok)
                    if ce is None:
                        if self.eg.pending:
                            continue   # saturation budget-truncated — resume
                        break
                    before = len(self.related)
                    self._mark_related(ce)
                    if len(self.related) == before:
                        break
                if ce is None:
                    diag = self.eg.extract_any(self.eg.find(c_out), leaf_ok)
                    in_maps = {}
                    for leaf in term.leaves():
                        if leaf.op == "tensor" and leaf.name in self.relation:
                            in_maps[leaf.name] = self.relation[leaf.name]
                    err = RefinementError(i, term.op, out_name, in_maps, diag)
                    if self.explain:
                        fired = {k: self.fire_counts.get(k, 0)
                                 - fires_at_op.get(k, 0)
                                 for k in self.fire_counts}
                        err.explanation = build_failure_frontier(
                            self, i, term.op, out_name, in_maps, diag, fired)
                    raise err
                self.relation[out_name] = ce
                self._mark_related(ce)

        # Final filter (Listing 1 line 9): R_o maps G_s outputs to
        # expressions over G_d *outputs* only — intermediate per-rank
        # tensors (e.g. pre-psum partials) are not observable results.
        out_names = set(self.gd.outputs)
        out_ok = lambda n: n in out_names or n in self.gd.consts
        r_o = {}
        for o in self.gs.outputs:
            if o in self.gs.consts or o in self.r_i:
                continue  # passthrough outputs
            c = self.eg.add_term(self.gs.tensor(o))
            ce = self._extract(c, out_ok)
            if ce is None:
                diag = self.eg.extract_any(self.eg.find(c), out_ok)
                err = RefinementError(
                    len(self.gs.defs), "output-filter", o,
                    {o: self.relation.get(o)}, diag,
                    message="output maps to internal G_d tensors but not to "
                            "G_d outputs (Listing 1 line 9 filter)")
                if self.explain:
                    maps = {o: self.relation[o]} if o in self.relation else {}
                    err.explanation = build_failure_frontier(
                        self, len(self.gs.defs), "output-filter", o,
                        maps, diag, {})
                raise err
            r_o[o] = ce
        stats = {
            "time_s": time.perf_counter() - t0,
            "egraph_nodes": self.eg.n_nodes,
            "gs_ops": len(self.gs.defs),
            "gd_ops": len(self.gd.defs),
            "lemma_fires": dict(self.fire_counts),
            "lemmas": self.profile.lemma_stats(
                self.fire_counts if self.collect_lemma_stats else None),
            "phase_s": self.profile.phase_seconds(),
            "counters": self.profile.counter_values(),
            "opt": CONFIG.as_dict(),
        }
        REGISTRY.counter("engine.runs").inc()
        REGISTRY.counter("engine.lemma_fires").inc(
            sum(self.fire_counts.values()))
        REGISTRY.histogram("engine.infer_s").observe(stats["time_s"])
        REGISTRY.histogram("engine.egraph_nodes").observe(self.eg.n_nodes)
        cert = Certificate(r_o, dict(self.relation), stats)
        if self.explain:
            # built after the stats snapshot so every stats field (and the
            # certificate payload) is byte-identical with explanations off
            with obs_trace.span("explain.build", cat="engine"):
                cert.explanation = build_certificate_explanation(self, r_o)
            REGISTRY.counter("engine.explain_steps").inc(
                cert.explanation["total_steps"])
            obs_trace.event("explain", cat="engine", outputs=len(r_o),
                            steps=cert.explanation["total_steps"])
        return cert


def check_refinement(gs: Graph, gd: Graph, r_i: dict,
                     max_nodes: int = 400_000,
                     explain: Optional[bool] = None) -> Certificate:
    """One-shot refinement check: does ``gd`` (multi-rank) refine ``gs``
    given input relation ``r_i``?  Returns a :class:`Certificate` or raises
    :class:`RefinementError` with the first unresolvable operator.
    ``explain=True`` additionally records proof provenance (see
    ``repro.core.explain``); None defers to ``GRAPHGUARD_EXPLAIN``."""
    return GraphGuard(gs, gd, r_i, max_nodes=max_nodes, explain=explain).run()

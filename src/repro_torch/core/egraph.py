"""EGraph: equality saturation engine for GraphGuard relation inference.

A pure-Python reimplementation of the egg-style e-graph the paper builds on
(Willsey et al., POPL'21): hash-consed e-nodes, union-find over e-classes,
congruence closure via worklist repair, and a saturation driver that applies
procedural *lemmas* (see ``repro_torch.core.lemmas``).

Differences from egg, driven by GraphGuard's use (paper §4.2.2, §4.3.2):
  * Lemmas are procedural Python matchers rather than declarative patterns —
    lemma conditions need shape arithmetic and (occasionally) the affine
    scalar solver, which is natural in Python.
  * Each e-class carries a shape/dtype analysis; merging classes with
    disagreeing shapes is an internal soundness error (fail loudly).
  * Clean-expression extraction (paper's step 4) is built in: for a class, we
    search for the minimum-cost expression whose interior ops are CLEAN_OPS
    and whose leaves lie in a caller-supplied set of tensors.
  * "Pruning self-provable expressions" (§4.3.2) falls out of extraction: we
    always keep the *simplest* representative; the e-graph stores the rest
    compactly by sharing.

Hot-path engineering (gated by ``repro_torch.core.profile.CONFIG``):
  * ``saturate`` dispatches lemmas through an op-indexed table built once per
    lemma list, instead of scanning every lemma per pending node.
  * Congruence repair (``rebuild``) runs once per saturation round (egg's
    deferred-rebuild result) instead of after every pending node.
  * Extraction is a worklist cost propagation with a per-class cost cache
    keyed on the union version: re-extracting after no growth is a dict hit,
    and after growth only classes whose costs could have changed recompute.
  * ``nodes_of`` caches canonical node sets per class, invalidated by union
    version plus targeted pops on node insertion.

Extraction breaks cost ties with a deterministic term order (``Term.sort_key``)
so certificates are bit-identical whether the optimizations are on or off.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..obs import trace as obs_trace
from .profile import CONFIG
from .terms import Term, CLEAN_OPS, tensor as mk_tensor


class ENode:
    """One operator node in the e-graph: op name, hashable attrs, and
    child e-class ids.  Hash-consed — equal nodes share one entry."""
    __slots__ = ("op", "attrs", "children", "_hash")

    def __init__(self, op: str, attrs: tuple, children: tuple):
        self.op = op
        self.attrs = attrs
        self.children = children
        self._hash = hash((op, attrs, children))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (self.op == other.op and self.attrs == other.attrs
                and self.children == other.children)

    def canonical(self, find) -> "ENode":
        ch = tuple(find(c) for c in self.children)
        if ch == self.children:
            return self
        return ENode(self.op, self.attrs, ch)

    def __repr__(self):
        return f"ENode({self.op}, {self.attrs}, {self.children})"


def _node_key(n: ENode) -> tuple:
    """Structural sort key for ENodes.  Member sets are Python sets, so
    their iteration order follows hash randomization; everything that
    *iterates* members (``nodes_of``, merge's pending re-queue) sorts by
    this key first, keeping lemma dispatch — and therefore the proof
    journal — identical across processes and PYTHONHASHSEED values."""
    return (n.op, n.children, repr(n.attrs))


class EClassInfo:
    """Per-e-class bookkeeping: member nodes, parent back-edges, the class
    shape/dtype invariant, known tensor leaves, and the GraphGuard T_rel
    frontier marker."""
    __slots__ = ("nodes", "parents", "shape", "dtype", "tensors", "related")

    def __init__(self, shape, dtype):
        self.nodes: set[ENode] = set()
        self.parents: list[tuple[ENode, int]] = []
        self.shape = shape
        self.dtype = dtype
        # tensor names (leaves) known to live in this class
        self.tensors: set[str] = set()
        # GraphGuard T_rel marker (frontier optimization, Listing 3)
        self.related: bool = False


class EGraph:
    """Congruence-closed e-graph over the term language: union-find +
    hashcons + per-class info, with op-indexed lemma dispatch, deferred
    rebuilds, and a node budget (``EGraphLimit`` past ``max_nodes``)."""

    def __init__(self, max_nodes: int = 200_000, explain: bool = False):
        self.uf: list[int] = []
        self.classes: dict[int, EClassInfo] = {}
        self.hashcons: dict[ENode, int] = {}
        self.worklist: list[int] = []
        self.pending: list[tuple[ENode, int]] = []  # (node, class) for lemma queue
        self.max_nodes = max_nodes
        # --- proof provenance (egg-style explanations) -------------------
        # With ``explain`` on, every union is journaled as an edge between
        # its two pre-union roots plus the justification that caused it, and
        # every class id keeps its creating e-node + shape/dtype.  The edge
        # graph has exactly one edge per union, so two ids are uf-equal iff
        # an edge path connects them — ``repro_torch.core.explain`` walks those
        # paths to rebuild lemma chains.  Off (the default), no extra state
        # is kept and behaviour is byte-identical.
        self.explain = bool(explain)
        self.explain_edges: list[tuple[int, int, Optional[tuple]]] = []
        self.node_meta: dict[int, tuple[ENode, tuple, str]] = {}
        self.n_nodes = 0
        self.version = 0  # bumped on every union; cheap fixpoint detection
        self.profile = None  # optional repro_torch.core.profile.Profile
        # --- caches (see module docstring) -------------------------------
        # class root -> ({op: [ENode]}, [ENode]); invalidated by targeted
        # pops: a union pops the two merged roots and the losing side's
        # parent classes (whose members' canonical forms changed), node
        # insertion pops the owning class. Stale *children* inside cached
        # nodes are harmless — all consumers resolve children via find().
        self._nodes_cache: dict[int, tuple] = {}
        # (id(leaf_ok), clean_only, max_cost, max_reach) ->
        #   (version, best: {cid: (Term, cost)}, reach: frozenset, log_len)
        self._extract_cache: dict[tuple, tuple] = {}
        # append-only log of merge roots; extraction seeds recomputation
        # from the suffix written since its cached snapshot
        self._merge_log: list[int] = []
        # (lemma list identity, {op: [Lemma]})
        self._lemma_idx: Optional[tuple] = None

    # -- union-find ---------------------------------------------------------
    def find(self, a: int) -> int:
        while self.uf[a] != a:
            self.uf[a] = self.uf[self.uf[a]]
            a = self.uf[a]
        return a

    def _new_class(self, shape, dtype) -> int:
        cid = len(self.uf)
        self.uf.append(cid)
        self.classes[cid] = EClassInfo(shape, dtype)
        return cid

    # -- adding terms / nodes ------------------------------------------------
    def add_term(self, t: Term) -> int:
        """Intern a Term, returning its e-class id. ``cls`` leaves are
        references to existing e-classes (used by procedural lemmas to build
        rewritten terms over classes rather than concrete terms)."""
        if t.op == "cls":
            return self.find(t.attr("id"))
        if t.op == "tensor":
            node = ENode("tensor", t.attrs, ())
        elif t.op == "lit":
            node = ENode("lit", t.attrs, ())
        else:
            ch = tuple(self.add_term(a) for a in t.args)
            node = ENode(t.op, t.attrs, ch)
        return self.add_enode(node, t.shape, t.dtype)

    def add_enode(self, node: ENode, shape, dtype) -> int:
        node = node.canonical(self.find)
        hit = self.hashcons.get(node)
        if hit is not None:
            return self.find(hit)
        if self.n_nodes >= self.max_nodes:
            raise EGraphLimit(f"egraph node limit {self.max_nodes} exceeded")
        cid = self._new_class(shape, dtype)
        if self.explain:
            self.node_meta[cid] = (node, shape, dtype)
        info = self.classes[cid]
        info.nodes.add(node)
        if node.op == "tensor":
            info.tensors.add(dict(node.attrs)["name"])
        self.hashcons[node] = cid
        for c in node.children:
            self.classes[self.find(c)].parents.append((node, cid))
        self.n_nodes += 1
        self.pending.append((node, cid))
        return cid

    # -- merging -------------------------------------------------------------
    def merge(self, a: int, b: int, reason: Optional[tuple] = None) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        ia, ib = self.classes[a], self.classes[b]
        if ia.shape != ib.shape and ia.shape != () and ib.shape != ():
            raise EGraphShapeError(
                f"merging classes with shapes {ia.shape} vs {ib.shape}")
        if self.explain:
            # journal with the pre-union roots: each union joins exactly two
            # edge-graph components, keeping connectivity ⟺ uf-equality
            self.explain_edges.append((a, b, reason))
        # keep the class with more parents as the root (union by size-ish)
        if len(ia.parents) < len(ib.parents):
            a, b = b, a
            ia, ib = ib, ia
        self.uf[b] = a
        ia.nodes |= ib.nodes
        ia.parents.extend(ib.parents)
        ia.tensors |= ib.tensors
        ia.related |= ib.related
        if ia.shape == ():
            ia.shape = ib.shape
        self.classes.pop(b)
        self.worklist.append(a)
        # Re-queue parents (ops whose children gained representations) and
        # members (constrained lemmas scan sibling reps) of the merged class.
        for pnode, pcid in ia.parents:
            self.pending.append((pnode, pcid))
        for n in sorted(ib.nodes, key=_node_key):
            self.pending.append((n, a))
        self.version += 1
        nc = self._nodes_cache
        nc.pop(a, None)
        nc.pop(b, None)
        # members of b's old parent classes now canonicalize differently
        for _pnode, pcid in ib.parents:
            nc.pop(self.find(pcid), None)
        self._merge_log.append(a)
        return a

    def rebuild(self):
        """Congruence closure repair (egg's rebuild)."""
        if not self.worklist:
            return
        prof = self.profile
        t0 = time.perf_counter() if prof is not None else 0.0
        while self.worklist:
            todo = sorted({self.find(c) for c in self.worklist})
            self.worklist.clear()
            for cid in todo:
                self._repair(cid)
        if prof is not None:
            t1 = time.perf_counter()
            prof.add_time("rebuild", t1 - t0)
            tracer = obs_trace.current()
            if tracer is not None and t1 - t0 >= 1e-4:
                # only spans wide enough to see — congruence repair runs
                # every round and would otherwise dominate the event log
                tracer.span_from("rebuild", t0, t1)

    def _repair(self, cid: int):
        info = self.classes.get(cid)
        if info is None:
            return
        new_parents: dict[ENode, int] = {}
        for pnode, pcid in info.parents:
            stale = self.hashcons.pop(pnode, None)
            canon = pnode.canonical(self.find)
            pcid = self.find(pcid)
            if canon in new_parents:
                self.merge(pcid, new_parents[canon],
                           ("congruence", canon.op) if self.explain else None)
                pcid = self.find(pcid)
            else:
                if stale is None and canon in self.hashcons:
                    self.merge(pcid, self.hashcons[canon],
                               ("congruence", canon.op) if self.explain
                               else None)
                    pcid = self.find(pcid)
            new_parents[canon] = pcid
            self.hashcons[canon] = pcid
            # keep node sets canonical too
            owner = self.classes.get(pcid)
            if owner is not None:
                owner.nodes.add(canon)
                self._nodes_cache.pop(pcid, None)
        info.parents = list(new_parents.items())

    # -- queries --------------------------------------------------------------
    def info(self, cid: int) -> EClassInfo:
        return self.classes[self.find(cid)]

    def nodes_of(self, cid: int, op: Optional[str] = None) -> list[ENode]:
        r = self.find(cid)
        cached = CONFIG.cached_nodes
        if cached:
            ent = self._nodes_cache.get(r)
            if ent is not None:
                if op is None:
                    return ent[1]
                return ent[0].get(op, [])
        info = self.classes[r]
        canon: list[ENode] = []
        by_op: dict[str, list[ENode]] = {}
        seen = set()
        for n in info.nodes:
            cn = n.canonical(self.find)
            if cn in seen:
                continue
            seen.add(cn)
            canon.append(cn)
        # structural order, not set-iteration order: lemma matching walks
        # these lists, and hash-randomized order would make the proof
        # journal differ between processes (see _node_key)
        canon.sort(key=_node_key)
        for cn in canon:
            by_op.setdefault(cn.op, []).append(cn)
        if cached:
            self._nodes_cache[r] = (by_op, canon)
        if op is None:
            return canon
        return by_op.get(op, [])

    def class_of_tensor(self, name: str, shape, dtype="f") -> int:
        return self.add_term(mk_tensor(name, shape, dtype))

    # -- saturation -----------------------------------------------------------
    def _lemma_index(self, lemmas: list) -> dict:
        """Op -> applicable lemmas (original order), built once per list."""
        if self._lemma_idx is not None and self._lemma_idx[0] is lemmas:
            return self._lemma_idx[1]
        ops = set()
        for lem in lemmas:
            if lem.ops is not None:
                ops |= lem.ops
        table = {op: [lem for lem in lemmas
                      if lem.ops is None or op in lem.ops]
                 for op in ops}
        # ops with no op-specific lemma still get the wildcard lemmas
        table[None] = [lem for lem in lemmas if lem.ops is None]
        self._lemma_idx = (lemmas, table)
        return table

    def saturate(self, lemmas: list, max_iters: int = 30,
                 fire_counts: Optional[dict] = None,
                 node_budget: int = 20000) -> None:
        """Run lemma application to (bounded) fixpoint.

        Each lemma is ``lemma(eg, node, cid) -> list[(Term|int, Term|int)]`` of
        equalities to install (paper: bidirectional rewrites; the e-graph makes
        direction irrelevant). ``node_budget`` bounds the nodes added per
        call — exceeding it stops saturation early (a completeness/perf
        trade, like the paper's constrained lemmas; soundness unaffected).
        """
        start_nodes = self.n_nodes
        prof = self.profile
        indexed = CONFIG.indexed_dispatch
        deferred = CONFIG.deferred_rebuild
        table = self._lemma_index(lemmas) if indexed else None
        # tracing-only per-lemma accounting; behaviour (and the Profile
        # per-lemma counters) is identical with the tracer off
        tracer = obs_trace.current()
        lemma_ms: Optional[dict] = {} if tracer is not None else None
        fires_delta: Optional[dict] = {} if tracer is not None else None
        for _ in range(max_iters):
            if self.n_nodes - start_nodes > node_budget:
                break
            batch = self.pending
            self.pending = []
            # dedupe: merges re-queue whole classes; canonicalize first
            seen = set()
            uniq = []
            for node, cid in batch:
                node = node.canonical(self.find)
                cid = self.find(cid)
                if (node, cid) in seen:
                    continue
                seen.add((node, cid))
                uniq.append((node, cid))
            before = self.version
            grew = False
            for node, cid in uniq:
                cid = self.find(cid)
                node = node.canonical(self.find)
                if indexed:
                    cand = table.get(node.op)
                    if cand is None:
                        cand = table[None]
                else:
                    cand = lemmas
                if prof is not None:
                    prof.count("nodes_dispatched")
                    prof.count("lemma_scan_len",
                               len(cand) if indexed else len(lemmas))
                for lem in cand:
                    if not indexed and lem.ops is not None \
                            and node.op not in lem.ops:
                        continue
                    try:
                        if lemma_ms is None:
                            eqs = lem.fn(self, node, cid)
                        else:
                            _lt0 = time.perf_counter()
                            eqs = lem.fn(self, node, cid)
                            lemma_ms[lem.name] = lemma_ms.get(lem.name, 0.0) \
                                + (time.perf_counter() - _lt0) * 1e3
                    except EGraphLimit:
                        raise
                    if prof is not None:
                        prof.count("lemma_calls")
                        prof.count_lemma(lem.name, bool(eqs))
                    if not eqs:
                        continue
                    if prof is not None:
                        prof.count("lemma_hits")
                    if fire_counts is not None:
                        fire_counts[lem.name] = fire_counts.get(lem.name, 0) + len(eqs)
                    if fires_delta is not None:
                        fires_delta[lem.name] = \
                            fires_delta.get(lem.name, 0) + len(eqs)
                    for lhs, rhs in eqs:
                        la = lhs if isinstance(lhs, int) else self.add_term(lhs)
                        ra = rhs if isinstance(rhs, int) else self.add_term(rhs)
                        if self.find(la) != self.find(ra):
                            self.merge(la, ra,
                                       ("lemma", lem.name) if self.explain
                                       else None)
                            grew = True
                if not deferred:
                    self.rebuild()
                if self.n_nodes - start_nodes > node_budget:
                    break
            # batched congruence repair: once per round (egg's deferred
            # rebuild) instead of once per pending node
            self.rebuild()
            if not self.pending and not grew and self.version == before:
                break
        if tracer is not None:
            tracer.event(
                "saturate.batch", cat="engine",
                fires={k: fires_delta[k] for k in sorted(fires_delta)},
                ms={k: round(lemma_ms[k], 3) for k in sorted(lemma_ms)})
            tracer.counter("egraph", nodes=self.n_nodes,
                           classes=len(self.classes))

    # -- clean extraction (paper step 4) ---------------------------------------
    def extract_clean(self, cid: int, leaf_ok: Callable[[str], bool],
                      max_cost: int = 40) -> Optional[Term]:
        """Find min-cost Term for class ``cid`` with interior ops in CLEAN_OPS
        and all tensor leaves satisfying ``leaf_ok(name)``. Literal leaves are
        allowed (they parameterize slices etc.)."""
        return self._extract(cid, leaf_ok, clean_only=True, max_cost=max_cost)

    def extract_any(self, cid: int, leaf_ok: Callable[[str], bool],
                    max_cost: int = 60) -> Optional[tuple[Term, int]]:
        """Extraction minimizing (#unclean ops, size) — for diagnostics.
        Returns (term, n_unclean) or None."""
        costs = self._bellman(cid, leaf_ok, clean_only=False, max_cost=max_cost)
        ent = costs.get(self.find(cid))
        if ent is None:
            return None
        term, (unclean, _) = ent
        return term, unclean

    def _extract(self, cid, leaf_ok, clean_only, max_cost):
        costs = self._bellman(cid, leaf_ok, clean_only, max_cost)
        ent = costs.get(self.find(cid))
        return None if ent is None else ent[0]

    @staticmethod
    def _better(cand: tuple, cur: tuple) -> bool:
        """Deterministic total order on (term, cost): cost first, then the
        structural term key — ties must resolve identically regardless of
        node iteration order so certificates don't depend on opt toggles."""
        if cand[1] != cur[1]:
            return cand[1] < cur[1]
        if cand[0] is cur[0]:
            return False
        return cand[0].sort_key() < cur[0].sort_key()

    def _bellman(self, root, leaf_ok, clean_only, max_cost,
                 max_reach: int = 4000):
        """Worklist cost propagation over the e-graph (handles cycles).

        cost = (unclean_ops, nodes); clean_only treats unclean as infeasible.
        With ``CONFIG.incremental_extract`` the per-class results are cached
        keyed on the union version: an unchanged graph returns the cached
        table outright; after growth only classes whose membership changed
        (plus newly reachable ones) are re-seeded, and improvements propagate
        upward through in-reach parent edges. Costs are monotone under e-graph
        growth (classes only gain representations), so stale entries are
        valid upper bounds — never wrong answers.
        """
        root = self.find(root)
        prof = self.profile
        incremental = CONFIG.incremental_extract
        if not incremental:
            return self._bellman_sweep(root, leaf_ok, clean_only, max_cost,
                                       max_reach)
        # key on the predicate object itself (the dict keeps it alive) —
        # an id() key would alias a GC-reused address to the wrong predicate
        key = (leaf_ok, clean_only, max_cost, max_reach)
        if prof is not None:
            prof.count("extract_calls")
        cached = self._extract_cache.get(key)
        if cached is not None and cached[0] == self.version \
                and root in cached[2]:
            if prof is not None:
                prof.count("extract_cache_hits")
            return cached[1]

        # restrict attention to classes reachable from root; upward
        # propagation reuses the e-graph's maintained parent lists (a
        # superset of in-reach edges, filtered by reach membership below)
        reach, truncated = self._reach(root, max_reach)

        best: dict[int, tuple[Term, tuple[int, int]]] = {}
        if cached is not None:
            cver, cbest, creach, clog = cached
            # cached entries stay valid upper bounds; remap to current roots
            for c, ent in cbest.items():
                r = self.find(c)
                if r not in reach:
                    continue
                cur = best.get(r)
                if cur is None or self._better(ent, cur):
                    best[r] = ent
            creach_now = {self.find(c) for c in creach}
            seed = {r for r in reach if r not in creach_now}
            for c in self._merge_log[clog:]:
                r = self.find(c)
                if r in reach:
                    seed.add(r)
        else:
            seed = set(reach)

        wl = deque(seed)
        inq = set(seed)
        # A merge can make a *parent* newly feasible without improving the
        # merged class's own best (e.g. an infeasible class folded into a
        # feasible one: the winner's recompute shows no improvement, so the
        # improvement cascade alone would never reach the parent). Seed
        # classes therefore notify their in-reach parents unconditionally.
        if cached is not None:
            for c in tuple(seed):
                info = self.classes.get(c)
                if info is None:
                    continue
                for _pnode, pcid in info.parents:
                    p = self.find(pcid)
                    if p in reach and p not in inq:
                        inq.add(p)
                        wl.append(p)
        while wl:
            c = wl.popleft()
            inq.discard(c)
            info = self.classes.get(c)
            if info is None:
                continue
            improved = False
            for n in self.nodes_of(c):
                cand = self._node_cost(n, best, leaf_ok, clean_only,
                                       info, max_cost)
                if cand is None:
                    continue
                cur = best.get(c)
                if cur is None or self._better(cand, cur):
                    best[c] = cand
                    improved = True
            if improved:
                for _pnode, pcid in info.parents:
                    p = self.find(pcid)
                    if p in reach and p not in inq:
                        inq.add(p)
                        wl.append(p)
        if not truncated:
            # a max_reach-truncated table is root-specific (other roots'
            # subtrees were never explored) — never serve it from cache
            self._extract_cache[key] = (self.version, best, frozenset(reach),
                                        len(self._merge_log))
        return best

    def _reach(self, root: int, max_reach: int) -> tuple[set, bool]:
        """Classes reachable from ``root``; truncated=True if max_reach hit."""
        reach: set[int] = set()
        stack = [root]
        while stack:
            c = self.find(stack.pop())
            if c in reach:
                continue
            reach.add(c)
            if len(reach) > max_reach:
                return reach, True
            for n in self.nodes_of(c):
                for ch in n.children:
                    stack.append(self.find(ch))
        return reach, False

    def _bellman_sweep(self, root, leaf_ok, clean_only, max_cost,
                       max_reach: int = 4000):
        """Pre-optimization baseline: full fixed-point re-sweeps over the
        reachable set (the seed engine's extraction). Kept behind
        ``CONFIG.incremental_extract = False`` so benchmarks can measure the
        worklist + cache variant against it on the same commit; uses the same
        ``_better`` tie-break so both produce identical certificates."""
        reach, _truncated = self._reach(root, max_reach)
        best: dict[int, tuple[Term, tuple[int, int]]] = {}
        changed = True
        iters = 0
        while changed and iters < 30:
            changed = False
            iters += 1
            for c in reach:
                info = self.classes.get(c)
                if info is None:
                    continue
                for n in self.nodes_of(c):
                    cand = self._node_cost(n, best, leaf_ok, clean_only,
                                           info, max_cost)
                    if cand is None:
                        continue
                    cur = best.get(c)
                    if cur is None or self._better(cand, cur):
                        best[c] = cand
                        changed = True
        return best

    def _node_cost(self, n: ENode, best, leaf_ok, clean_only, info, max_cost):
        if n.op == "tensor":
            name = dict(n.attrs)["name"]
            if leaf_ok(name):
                return (Term("tensor", (), n.attrs, info.shape, info.dtype),
                        (0, 0))
            return None
        if n.op == "lit":
            return Term("lit", (), n.attrs, (), info.dtype), (0, 0)
        unclean = 0 if n.op in CLEAN_OPS else 1
        if clean_only and unclean:
            return None
        args = []
        tot_u, tot_s = unclean, 1
        for ch in n.children:
            ent = best.get(self.find(ch))
            if ent is None:
                return None
            args.append(ent[0])
            tot_u += ent[1][0]
            tot_s += ent[1][1] + 1
        if tot_s > max_cost:
            return None
        term = Term(n.op, tuple(args), n.attrs, info.shape, info.dtype)
        return term, (tot_u, tot_s)


class EGraphShapeError(AssertionError):
    """Two terms merged into one e-class disagree on shape/dtype — a lemma
    or capture bug, never a user error."""


class EGraphLimit(RuntimeError):
    """The e-graph grew past its ``max_nodes`` budget during saturation."""


class Lemma:
    """A rewrite rule (paper §4.2.1). ``ops``: trigger op names (None = all).
    ``fn(eg, node, cid)`` returns equalities [(lhs, rhs), ...] as Terms or
    class ids."""

    __slots__ = ("name", "ops", "fn", "source")

    def __init__(self, name: str, ops, fn, source: str = "builtin"):
        self.name = name
        self.ops = frozenset(ops) if ops is not None else None
        self.fn = fn
        self.source = source

    def __repr__(self):
        return f"Lemma({self.name})"

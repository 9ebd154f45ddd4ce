"""Serving strategies: decode-step and prefill-read obligations.

Each strategy models one real sharded-KV-cache serving recipe for the
shared single-layer attention fragment (project keys/values into a
``(seq, feat)`` cache, attend with the last position's query).  The
refinement claim is the serving-path soundness argument: *N incremental
decode steps chained over the sharded cache refine full-sequence
prefill*.  It decomposes exactly like modelcheck's block argument:

  step t   the sequential single-position cache write
           (``dynamic_update_slice`` at row ``t``) is refined by the
           rank-local/rank-conditional distributed write — one
           obligation per decode step, deduped by *position class*;
  read     the full decode chain from a zeros cache, re-captured
           end-to-end, plus the attention read through the gathered
           cache — one obligation proving the chained steps compose
           (this is where the ``dus_concat``/``dus_unfold`` lemmas
           flatten the N-link update chain into the prefill concat).

Strategies::

  ``tp_decode``      tensor-parallel serving — cache feature-sharded
                     (layout ``heads``); writes are local, the read
                     gathers on the feature dim.
  ``sp_cache``       sequence-parallel cache — cache row-sharded
                     (layout ``seq``); writes are rank-conditional
                     (``where(axis_index == owner, upd, cache)``, folded
                     per-rank by the engine's select fold), reads gather
                     on the position dim.
  ``batched_decode`` continuous batching on a dp x tp mesh — two
                     requests at *different* positions decode together:
                     dp gathers the 2-token batch, tp shards the cache
                     features.  Positions rotate per step, so every step
                     is its own position class (dedup ratio 1 — the
                     documented contrast case to tp/sp).

Position classes (the dedup identity, carried as a ``structure`` fact in
place of the step index): ``tp_decode`` steps differ only in where the
written row sits relative to the cache ends (``first``/``mid``/``last``
— 8 steps collapse to 3 obligations); ``sp_cache`` steps differ in the
*local* offset on the owner's shard (``lfirst``/``lmid``/``llast`` —
the owner rank itself is symmetric under the mesh, so steps landing on
different ranks at the same local offset share one obligation).

The three injected bug classes are the serving analogues of the bug
study (PAPERS.md):

  ``stale_cache_shard``       (tp_decode, step 3) rank 0's feature shard
                              keeps the pre-write cache — the
                              skipped-write/stale-page KV class.
  ``pos_off_by_one``          (sp_cache, step 4) the owner writes local
                              row ``loc + 1`` — the global-vs-local
                              position-arithmetic class.
  ``cache_gather_wrong_axis`` (batched_decode, step 1) the token batch
                              is gathered over tp instead of dp.  Each
                              request's cache is still *reconstructible*
                              from the ranks that computed it correctly,
                              so refinement holds — but the inferred R_o
                              shifts off the spec-promised relation and
                              the seam check flags it
                              (``unexpected_relation``, the paper's
                              silent-misplacement detection mode).

A bug changes its step's structure fingerprint, splitting the step out
of its position class — which is exactly how :class:`ServeReport`
localizes it to the failing step while the class siblings stay clean.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..api.spec import BugSpec, Degree, TensorSpec, axis_degrees, \
    normalize_degree
from ..core import spmd
from ..core.spmd import PartitionSpec as P
from ..modelcheck.obligations import Obligation, ObligationSet
from ..sharding.specs import parse_plan
from .relations import cache_spec, seq_parallel_plan

# serving fragment sizes (symbolic engine: cost is op count x degree, not
# extents).  S is the decode horizon for the single-request strategies;
# the batched strategy halves it — its read chain carries 4 interleaved
# dus chains, and 4 steps already exercise a full position rotation.
S, SB, D_MODEL, HD = 8, 4, 4, 4


def _aval(shape):
    return TensorSpec(tuple(shape), torch.float32)


def _zeros(shape, like):
    """A float32 cache of zeros on ``like``'s device (``jnp.zeros``)."""
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _obligation(kind, seq_fn, dist_fn, plan, in_specs, out_specs, avals,
                names, *, strategy, role, pos_class, bug=None,
                description=""):
    return Obligation(
        kind=kind, seq_fn=seq_fn, dist_fn=dist_fn,
        mesh_axes=tuple(plan.axes), in_specs=tuple(in_specs),
        out_specs=tuple(out_specs), avals=tuple(avals),
        input_names=tuple(names),
        structure=tuple(sorted((
            ("strategy", strategy), ("role", role),
            ("pos_class", pos_class), ("bug", bug or "-")))),
        description=description)


@dataclass(frozen=True)
class ServeStrategy:
    """One serving recipe: per-step + read obligations, and its bugs."""
    name: str
    n_steps: int
    degrees: Tuple[Degree, ...]
    bugs: Tuple[BugSpec, ...]
    bug_steps: Mapping[str, int]         # bug name -> decode step it lands on
    description: str
    builder: Callable                    # (degree, bug) -> ObligationSet

    def bug_names(self) -> Tuple[str, ...]:
        return tuple(b.name for b in self.bugs)

    def bug_spec(self, bug: str) -> BugSpec:
        for b in self.bugs:
            if b.name == bug:
                return b
        raise KeyError(bug)

    def validate_degree(self, degree: Degree) -> Degree:
        degree = normalize_degree(degree)
        arities = {len(d) for d in self.degrees if isinstance(d, tuple)}
        if isinstance(degree, tuple):
            if not arities:
                raise ValueError(
                    f"serve strategy `{self.name}` is single-axis — it "
                    f"takes an int degree, not {degree}")
            if len(degree) not in arities:
                raise ValueError(
                    f"serve strategy `{self.name}` takes "
                    f"{sorted(arities)}-axis degrees, got {degree}")
        return degree

    def build(self, degree: Optional[Degree] = None,
              bug: Optional[str] = None) -> ObligationSet:
        """Materialize the obligation set: blocks ``step0..stepN-1, read``."""
        if degree is None:
            degree = self.degrees[0]
        degree = self.validate_degree(degree)
        if bug is not None and bug not in self.bug_names():
            hosts = [s.name for s in SERVE_STRATEGIES.values()
                     if bug in s.bug_names()]
            raise ValueError(
                f"bug `{bug}` belongs to serve strategy {hosts or '?'} — "
                f"running it under `{self.name}` would silently certify "
                f"the clean serving path")
        return self.builder(degree=degree, bug=bug)


SERVE_STRATEGIES: Dict[str, ServeStrategy] = {}


def register_serve_strategy(name: str, *, n_steps, degrees=(2, 4), bugs=(),
                            bug_steps=None, description=""):
    """Register a serving strategy (the servecheck registry — mirrors
    ``register_train_strategy`` for ``serve@strategy`` task ids).

    The decorated builder returns an :class:`ObligationSet` whose blocks
    are ``step0..step{n_steps-1}`` followed by ``read``.  Reject
    unsupported degrees with ``ValueError`` (never ``assert``: the CLI
    maps ValueError to exit code 2, and a bare assert would exit 1 — the
    code CI gates read as "bug localized")."""
    bug_specs = tuple(b if isinstance(b, BugSpec) else BugSpec(str(b))
                      for b in bugs)

    def deco(fn):
        if name in SERVE_STRATEGIES:
            raise ValueError(f"serve strategy `{name}` already registered")
        for s in SERVE_STRATEGIES.values():
            taken = set(s.bug_names()) & {b.name for b in bug_specs}
            if taken:
                raise ValueError(f"serve bug name(s) {sorted(taken)} "
                                 f"already registered under `{s.name}`")
        SERVE_STRATEGIES[name] = ServeStrategy(
            name=name, n_steps=int(n_steps),
            degrees=tuple(normalize_degree(d) for d in degrees),
            bugs=bug_specs, bug_steps=dict(bug_steps or {}),
            description=description or (fn.__doc__ or "").strip().split("\n")[0],
            builder=fn)
        return fn

    return deco


def list_serve_strategies() -> Tuple[str, ...]:
    return tuple(SERVE_STRATEGIES)


def get_serve_strategy(name: str) -> ServeStrategy:
    try:
        return SERVE_STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown serve strategy `{name}` — registered: "
                       f"{sorted(SERVE_STRATEGIES)}") from None


def list_serve_bugs() -> Dict[str, Tuple[str, BugSpec]]:
    """serve bug name -> (host strategy, BugSpec)."""
    out: Dict[str, Tuple[str, BugSpec]] = {}
    for s in SERVE_STRATEGIES.values():
        for b in s.bugs:
            out[b.name] = (s.name, b)
    return out


# ---------------------------------------------------------------------------
# tp_decode — tensor-parallel serving: feature-sharded cache, local writes
# ---------------------------------------------------------------------------

# Each fragment takes exactly its obligation's inputs: ``make_fx`` traces
# every parameter, defaulted ones included, so a step's position and bug
# flags are bound by the factories below rather than as keyword defaults.

def _seq_write(t: int) -> Callable:
    """The sequential decode write of row ``t`` into both caches."""
    def seq_step(x, wk, wv, ck, cv):
        xt = x[t:t + 1]
        ck = spmd.dynamic_update_slice(ck, xt @ wk, (t, 0))
        cv = spmd.dynamic_update_slice(cv, xt @ wv, (t, 0))
        return ck, cv
    return seq_step


def _seq_read(x, wk, wv, wq):
    """The sequential read: the S-step write chain from a zeros cache, then
    the last position's attention over it (tp_decode's and sp_cache's)."""
    ck = _zeros((S, HD), x)
    cv = _zeros((S, HD), x)
    for t in range(S):
        xt = x[t:t + 1]
        ck = spmd.dynamic_update_slice(ck, xt @ wk, (t, 0))
        cv = spmd.dynamic_update_slice(cv, xt @ wv, (t, 0))
    q = x[S - 1:S] @ wq
    return (q @ ck.T) @ cv


def _tp_write(t: int, stale: bool) -> Callable:
    def dist_step(x, wk, wv, ck, cv):
        xt = x[t:t + 1]
        upd_k = spmd.dynamic_update_slice(ck, xt @ wk, (t, 0))
        if stale:
            # BUG: rank 0's feature shard never lands the k write
            upd_k = torch.where(spmd.axis_index("tp") == 0, ck, upd_k)
        cv = spmd.dynamic_update_slice(cv, xt @ wv, (t, 0))
        return upd_k, cv
    return dist_step


@register_serve_strategy(
    "tp_decode", n_steps=S, degrees=(2, 4),
    bugs=[BugSpec("stale_cache_shard", "refinement_error",
                  "rank 0's feature shard keeps the pre-write cache — "
                  "the skipped-write / stale-KV-page class")],
    bug_steps={"stale_cache_shard": 3},
    description="TP serving: feature-sharded KV cache, local decode writes")
def tp_decode(degree: int = 2, bug=None) -> ObligationSet:
    """Every rank holds all S positions of its head slice, so a decode
    write is purely local (the dus row spans the rank's full feature
    shard) and only the read pays an all_gather on the feature dim.
    Position classes: the written row's relation to the cache ends —
    ``first`` (empty prefix), ``mid``, ``last`` (empty suffix) — so the
    S-step decode owes 3 step obligations, not S."""
    degree = normalize_degree(degree)
    if not isinstance(degree, int) or degree < 2 or HD % degree:
        raise ValueError(
            f"serve strategy `tp_decode` needs an int degree >= 2 dividing "
            f"the feature dim of {HD}, got {degree}")
    plan = parse_plan(f"tp{degree}")
    w_spec = plan.spec_for(("embed", "heads"))       # P(None, "tp")
    ck_spec = cache_spec(plan, "heads")              # P(None, "tp")
    x_aval, w_aval, c_aval = _aval((S, D_MODEL)), _aval((D_MODEL, HD)), \
        _aval((S, HD))
    obs = ObligationSet()

    for t in range(S):
        stale = bug == "stale_cache_shard" and t == 3
        seq_step, dist_step = _seq_write(t), _tp_write(t, stale)
        klass = "first" if t == 0 else ("last" if t == S - 1 else "mid")
        obs.add(f"step{t}", _obligation(
            "serve_step", seq_step, dist_step, plan,
            in_specs=(P(), w_spec, w_spec, ck_spec, ck_spec),
            out_specs=(ck_spec, ck_spec),
            avals=(x_aval, w_aval, w_aval, c_aval, c_aval),
            names=("x", "wk", "wv", "ck", "cv"),
            strategy="tp_decode", role="step", pos_class=klass,
            bug=bug if stale else None,
            description=f"tp decode write, position class {klass}"))

    def dist_read(x, wk, wv, wq):
        ck = _zeros((S, HD // degree), x)
        cv = _zeros((S, HD // degree), x)
        for t in range(S):
            xt = x[t:t + 1]
            ck = spmd.dynamic_update_slice(ck, xt @ wk, (t, 0))
            cv = spmd.dynamic_update_slice(cv, xt @ wv, (t, 0))
        full_k = spmd.all_gather(ck, "tp", axis=1, tiled=True)
        full_v = spmd.all_gather(cv, "tp", axis=1, tiled=True)
        q = x[S - 1:S] @ wq
        return (q @ full_k.T) @ full_v

    obs.add("read", _obligation(
        "serve_read", _seq_read, dist_read, plan,
        in_specs=(P(), w_spec, w_spec, P()), out_specs=(P(),),
        avals=(x_aval, w_aval, w_aval, w_aval),
        names=("x", "wk", "wv", "wq"),
        strategy="tp_decode", role="read", pos_class="full",
        description=f"tp prefill read: {S}-step chain + gathered attention"))
    return obs


# ---------------------------------------------------------------------------
# sp_cache — sequence-parallel cache: row-sharded, rank-conditional writes
# ---------------------------------------------------------------------------

def _sp_write(t: int, owner: int, loc: int, off: bool) -> Callable:
    def dist_step(x, wk, wv, ck, cv):
        xt = x[t:t + 1]
        # BUG (pos_off_by_one): the k row lands one past its local slot
        kloc = loc + 1 if off else loc
        upd_k = spmd.dynamic_update_slice(ck, xt @ wk, (kloc, 0))
        upd_v = spmd.dynamic_update_slice(cv, xt @ wv, (loc, 0))
        mine = spmd.axis_index("sp") == owner
        out_k = torch.where(mine, upd_k, ck)
        out_v = torch.where(mine, upd_v, cv)
        return (spmd.all_gather(out_k, "sp", axis=0, tiled=True),
                spmd.all_gather(out_v, "sp", axis=0, tiled=True))
    return dist_step


@register_serve_strategy(
    "sp_cache", n_steps=S, degrees=(2, 4),
    bugs=[BugSpec("pos_off_by_one", "refinement_error",
                  "the owner writes local row loc+1 — the global-vs-local "
                  "position-arithmetic class")],
    bug_steps={"pos_off_by_one": 4},
    description="Sequence-parallel KV cache: row-sharded, owner-only writes")
def sp_cache(degree: int = 2, bug=None) -> ObligationSet:
    """Each rank owns S/degree contiguous cache rows; step t lands only on
    rank ``t // L`` (``where(axis_index == owner, upd, cache)``, folded to
    a per-rank straight-line write by the engine's select fold) and the
    step output is the all_gather of the per-rank buffers — the gather is
    what groups the rank-split cache into one term the engine can relate
    to the sequential dus.  Position classes: the *local* offset on the
    owner's shard (``lfirst``/``lmid``/``llast``); the owner index itself
    is symmetric under the mesh, so steps landing on different ranks at
    the same local offset share one obligation."""
    degree = normalize_degree(degree)
    if not isinstance(degree, int) or degree < 2 or S % degree:
        raise ValueError(
            f"serve strategy `sp_cache` needs an int degree >= 2 dividing "
            f"the sequence length of {S}, got {degree}")
    plan = seq_parallel_plan(degree)
    local = S // degree
    w_spec = plan.spec_for(("embed", "heads"))       # replicated
    ck_spec = cache_spec(plan, "seq")                # P("sp", None)
    x_aval, w_aval, c_aval = _aval((S, D_MODEL)), _aval((D_MODEL, HD)), \
        _aval((S, HD))
    obs = ObligationSet()

    for t in range(S):
        owner, loc = t // local, t % local
        off = bug == "pos_off_by_one" and t == 4

        seq_step, dist_step = _seq_write(t), _sp_write(t, owner, loc, off)
        klass = "lfirst" if loc == 0 else \
            ("llast" if loc == local - 1 else "lmid")
        obs.add(f"step{t}", _obligation(
            "serve_step", seq_step, dist_step, plan,
            in_specs=(P(), w_spec, w_spec, ck_spec, ck_spec),
            out_specs=(P(), P()),            # gathered -> replicated
            avals=(x_aval, w_aval, w_aval, c_aval, c_aval),
            names=("x", "wk", "wv", "ck", "cv"),
            strategy="sp_cache", role="step", pos_class=klass,
            bug=bug if off else None,
            description=f"sp owner-conditional write, local class {klass}"))

    def dist_read(x, wk, wv, wq):
        ck = _zeros((local, HD), x)
        cv = _zeros((local, HD), x)
        me = spmd.axis_index("sp")
        for t in range(S):
            owner, loc = t // local, t % local
            xt = x[t:t + 1]
            upd_k = spmd.dynamic_update_slice(ck, xt @ wk, (loc, 0))
            upd_v = spmd.dynamic_update_slice(cv, xt @ wv, (loc, 0))
            mine = me == owner
            ck = torch.where(mine, upd_k, ck)
            cv = torch.where(mine, upd_v, cv)
        full_k = spmd.all_gather(ck, "sp", axis=0, tiled=True)
        full_v = spmd.all_gather(cv, "sp", axis=0, tiled=True)
        q = x[S - 1:S] @ wq
        return (q @ full_k.T) @ full_v

    obs.add("read", _obligation(
        "serve_read", _seq_read, dist_read, plan,
        in_specs=(P(), w_spec, w_spec, P()), out_specs=(P(),),
        avals=(x_aval, w_aval, w_aval, w_aval),
        names=("x", "wk", "wv", "wq"),
        strategy="sp_cache", role="read", pos_class="full",
        description=f"sp prefill read: {S}-step owner chain + row gather"))
    return obs


# ---------------------------------------------------------------------------
# batched_decode — continuous batching: dp gathers the token batch,
# tp shards cache features, positions rotate per step
# ---------------------------------------------------------------------------

def _batch_pos(t: int) -> Tuple[int, int]:
    """Request positions at step t: request a decodes in order, request b
    joined mid-stream (continuous batching) — its position is rotated by
    half the horizon, so no two steps share a position pair."""
    return t, (t + SB // 2) % SB


def _batched_seq_write(pa: int, pb: int) -> Callable:
    def seq_step(xa, xb, wk, wv, cka, cva, ckb, cvb):
        xta = xa[pa:pa + 1]
        xtb = xb[pb:pb + 1]
        cka = spmd.dynamic_update_slice(cka, xta @ wk, (pa, 0))
        cva = spmd.dynamic_update_slice(cva, xta @ wv, (pa, 0))
        ckb = spmd.dynamic_update_slice(ckb, xtb @ wk, (pb, 0))
        cvb = spmd.dynamic_update_slice(cvb, xtb @ wv, (pb, 0))
        return cka, cva, ckb, cvb
    return seq_step


def _batched_write(pa: int, pb: int, wrong: bool) -> Callable:
    def dist_step(xa, xb, wk, wv, cka, cva, ckb, cvb):
        xta = xa[pa:pa + 1]
        xtb = xb[pb:pb + 1]
        mine = spmd.axis_index("dp") == 0
        xloc = torch.where(mine, xta, xtb)         # my request's token
        # BUG (cache_gather_wrong_axis): gathering over tp hands every
        # dp rank its own token twice instead of the 2-request batch
        batch = spmd.all_gather(xloc, "tp" if wrong else "dp", axis=0,
                                tiled=True)
        k2, v2 = batch @ wk, batch @ wv          # (2, HD/tp)
        cka = spmd.dynamic_update_slice(cka, k2[0:1], (pa, 0))
        cva = spmd.dynamic_update_slice(cva, v2[0:1], (pa, 0))
        ckb = spmd.dynamic_update_slice(ckb, k2[1:2], (pb, 0))
        cvb = spmd.dynamic_update_slice(cvb, v2[1:2], (pb, 0))
        return cka, cva, ckb, cvb
    return dist_step


@register_serve_strategy(
    "batched_decode", n_steps=SB, degrees=((2, 2), (2, 4)),
    bugs=[BugSpec("cache_gather_wrong_axis", "unexpected_relation",
                  "the token batch is gathered over tp instead of dp — "
                  "refinement still holds (each request's cache is "
                  "reconstructible from the ranks that computed it), but "
                  "the inferred R_o shifts off the spec's relation and "
                  "the seam check flags it")],
    bug_steps={"cache_gather_wrong_axis": 1},
    description="Continuous batching on dp x tp: gathered 2-token batch, "
                "feature-sharded caches")
def batched_decode(degree=(2, 2), bug=None) -> ObligationSet:
    """Two requests decode together: each dp rank holds one request's
    current token, the step gathers the 2-token batch over dp, projects
    it through the tp-sharded weights once, and scatters the two rows
    into the two feature-sharded caches.  Request b joined mid-stream, so
    its write position is rotated — every step is its own position class
    and the dedup ratio is 1 (the documented contrast case: position
    classes, not step count, set the obligation count)."""
    d_dp, d_tp = axis_degrees(normalize_degree(degree), 2)
    if d_dp != 2:
        raise ValueError(
            f"serve strategy `batched_decode` serves exactly 2 concurrent "
            f"requests — dp must be 2, got ({d_dp}, {d_tp})")
    if d_tp < 2 or HD % d_tp:
        raise ValueError(
            f"serve strategy `batched_decode` needs tp >= 2 dividing the "
            f"feature dim of {HD}, got ({d_dp}, {d_tp})")
    if bug == "cache_gather_wrong_axis" and d_tp != d_dp:
        raise ValueError(
            f"bug `cache_gather_wrong_axis` swaps the dp gather for a tp "
            f"gather, which only type-checks on a square mesh — run it at "
            f"degree ({d_dp}, {d_dp}), not ({d_dp}, {d_tp})")
    plan = parse_plan(f"dp{d_dp}xtp{d_tp}")
    w_spec = plan.spec_for(("embed", "heads"))       # P(None, "tp")
    ck_spec = cache_spec(plan, "heads")              # P(None, "tp")
    x_aval, w_aval, c_aval = _aval((SB, D_MODEL)), _aval((D_MODEL, HD)), \
        _aval((SB, HD))
    local_hd = HD // d_tp
    obs = ObligationSet()

    for t in range(SB):
        pa, pb = _batch_pos(t)
        wrong = bug == "cache_gather_wrong_axis" and t == 1
        seq_step = _batched_seq_write(pa, pb)
        dist_step = _batched_write(pa, pb, wrong)
        obs.add(f"step{t}", _obligation(
            "serve_step", seq_step, dist_step, plan,
            in_specs=(P(), P(), w_spec, w_spec,
                      ck_spec, ck_spec, ck_spec, ck_spec),
            out_specs=(ck_spec, ck_spec, ck_spec, ck_spec),
            avals=(x_aval, x_aval, w_aval, w_aval,
                   c_aval, c_aval, c_aval, c_aval),
            names=("xa", "xb", "wk", "wv", "cka", "cva", "ckb", "cvb"),
            strategy="batched_decode", role="step",
            pos_class=f"pos{pa}-{pb}", bug=bug if wrong else None,
            description=f"batched write at positions ({pa}, {pb})"))

    def seq_read(xa, xb, wk, wv, wq):
        cka = _zeros((SB, HD), xa)
        cva = _zeros((SB, HD), xa)
        ckb = _zeros((SB, HD), xa)
        cvb = _zeros((SB, HD), xa)
        for t in range(SB):
            pa, pb = _batch_pos(t)
            xta = xa[pa:pa + 1]
            xtb = xb[pb:pb + 1]
            cka = spmd.dynamic_update_slice(cka, xta @ wk, (pa, 0))
            cva = spmd.dynamic_update_slice(cva, xta @ wv, (pa, 0))
            ckb = spmd.dynamic_update_slice(ckb, xtb @ wk, (pb, 0))
            cvb = spmd.dynamic_update_slice(cvb, xtb @ wv, (pb, 0))
        qa = xa[SB - 1:SB] @ wq
        qb = xb[SB - 1:SB] @ wq
        return (qa @ cka.T) @ cva, (qb @ ckb.T) @ cvb

    def dist_read(xa, xb, wk, wv, wq):
        cka = _zeros((SB, local_hd), xa)
        cva = _zeros((SB, local_hd), xa)
        ckb = _zeros((SB, local_hd), xa)
        cvb = _zeros((SB, local_hd), xa)
        for t in range(SB):
            pa, pb = _batch_pos(t)
            xta = xa[pa:pa + 1]
            xtb = xb[pb:pb + 1]
            mine = spmd.axis_index("dp") == 0
            xloc = torch.where(mine, xta, xtb)
            batch = spmd.all_gather(xloc, "dp", axis=0, tiled=True)
            k2, v2 = batch @ wk, batch @ wv
            cka = spmd.dynamic_update_slice(cka, k2[0:1], (pa, 0))
            cva = spmd.dynamic_update_slice(cva, v2[0:1], (pa, 0))
            ckb = spmd.dynamic_update_slice(ckb, k2[1:2], (pb, 0))
            cvb = spmd.dynamic_update_slice(cvb, v2[1:2], (pb, 0))
        full = [spmd.all_gather(c, "tp", axis=1, tiled=True)
                for c in (cka, cva, ckb, cvb)]
        qa = xa[SB - 1:SB] @ wq
        qb = xb[SB - 1:SB] @ wq
        return ((qa @ full[0].T) @ full[1], (qb @ full[2].T) @ full[3])

    obs.add("read", _obligation(
        "serve_read", seq_read, dist_read, plan,
        in_specs=(P(), P(), w_spec, w_spec, P()), out_specs=(P(), P()),
        avals=(x_aval, x_aval, w_aval, w_aval, w_aval),
        names=("xa", "xb", "wk", "wv", "wq"),
        strategy="batched_decode", role="read", pos_class="full",
        description=f"batched prefill read: {SB} rotated steps, 2 requests"))
    return obs

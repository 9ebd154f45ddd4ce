"""Train-step strategies and their per-parameter gradient obligations.

Each strategy models one real distributed-training recipe for the shared
two-matmul step (``loss = sum(tanh(x @ w1) @ w2)``, the Megatron MLP
fragment every family in this repo builds on):

  ``dp``        DDP: batch sharded, parameters replicated, local backward
                + gradient ``psum`` (the transposition of the replicated
                forward broadcast).
  ``dp_accum``  DDP with microbatch gradient accumulation into a
                ``dynamic_update_slice`` scatter buffer — the HF-regression
                pattern; certifies through the ``dus_concat`` lemma.
  ``fsdp``      ZeRO-3: parameters sharded dim 0, forward ``all_gather``,
                gradient ``reduce_scatter`` (transpose of the gather).
  ``tp_dp_2d``  Megatron TP x DP on a 2D mesh: col/row-sharded weights,
                batch sharded over dp; each weight gradient owes a ``psum``
                over *dp only* (the tp shard is exact by transposition).

A strategy yields one obligation per parameter — a plain
:class:`repro_torch.api.StrategySpec` whose seq side is ``torch.func.grad``
of the sequential loss and whose dist side is the per-rank local backward
wrapped in the strategy's collectives (``repro_torch.core.spmd``) — so the
unchanged engine verifies it and a failure localizes to *that parameter*.

The three injected bug classes are the gradient analogues of the
bug-study literature (TTrace; the LLM-framework bug study — PAPERS.md):

  ``accum_no_rescale``     (dp_accum/w2) the accumulated gradient is
                           normalized by the microbatch size instead of
                           the global batch — grads come out n_steps x
                           too large.
  ``stale_grad_shard``     (fsdp/w2) the ``reduce_scatter`` is skipped and
                           the rank keeps its *local partial*'s shard —
                           the stale-shard ZeRO class.
  ``grad_psum_wrong_axis`` (tp_dp_2d/w2) the gradient all-reduce runs
                           over tp instead of dp — partial batch sums are
                           never combined, tp shards are wrongly summed.

All bugs target ``w2`` (and only ``w2``), so detection must localize to
exactly that parameter — ``w1`` staying clean is part of the check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..api.spec import BugSpec, Degree, StrategySpec, TensorSpec, \
    axis_degrees, normalize_degree
from ..core import spmd
from ..core.spmd import PartitionSpec as P
from .capture_grad import grad_of

# shared train-step fragment sizes (symbolic engine: cost is op count x
# degree, not extents — keep them divisibility-friendly)
BATCH, D_MODEL, D_FF = 8, 4, 4
N_MICRO = 2
PARAMS = ("w1", "w2")
_ARGNUM = {"w1": 1, "w2": 2}


def _loss(x, w1, w2):
    return torch.sum(torch.tanh(x @ w1) @ w2)


def _aval(shape):
    return TensorSpec(tuple(shape), torch.float32)


_AVALS = (_aval((BATCH, D_MODEL)), _aval((D_MODEL, D_FF)),
          _aval((D_FF, D_MODEL)))
_NAMES = ("x", "w1", "w2")


def _bound(fn: Callable, **kw) -> Callable:
    """``fn`` with its keywords bound, taking only the step's inputs
    (``make_fx`` traces every parameter, defaulted ones included)."""
    def bound(x, w1, w2):
        return fn(x, w1, w2, **kw)
    return bound


@dataclass(frozen=True)
class TrainStrategy:
    """One distributed-training recipe: per-parameter obligations + bugs."""
    name: str
    params: Tuple[str, ...]
    degrees: Tuple[Degree, ...]
    bugs: Tuple[BugSpec, ...]
    bug_params: Mapping[str, str]        # bug name -> offending parameter
    description: str
    builder: Callable                    # (degree, bug) -> {param: spec...}

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
                    f"train strategy `{self.name}` is single-axis — it "
                    f"takes an int degree, not {degree}")
            if len(degree) not in arities:
                raise ValueError(
                    f"train strategy `{self.name}` takes "
                    f"{sorted(arities)}-axis degrees, got {degree}")
        return degree

    def build(self, degree: Optional[Degree] = None,
              bug: Optional[str] = None) -> Dict[str, StrategySpec]:
        """Materialize the per-parameter obligations (ordered by PARAMS)."""
        if degree is None:
            degree = self.degrees[0]
        degree = self.validate_degree(degree)
        if bug is not None and bug not in self.bug_names():
            hosts = [s.name for s in TRAIN_STRATEGIES.values()
                     if bug in s.bug_names()]
            raise ValueError(
                f"bug `{bug}` belongs to train strategy {hosts or '?'} — "
                f"running it under `{self.name}` would silently verify "
                f"the clean step")
        specs = self.builder(degree=degree, bug=bug)
        out = {}
        for param in self.params:
            expected = "certificate"
            if bug is not None and self.bug_params.get(bug) == param:
                expected = self.bug_spec(bug).expected
            out[param] = specs[param].with_identity(
                name=f"{self.name}:{param}", degree=degree,
                bug=bug if expected != "certificate" else None,
                expected=expected)
        return out


TRAIN_STRATEGIES: Dict[str, TrainStrategy] = {}


def register_train_strategy(name: str, *, params=PARAMS, degrees=(2, 4),
                            bugs=(), bug_params=None, description=""):
    """Register a train-step strategy (the gradcheck registry — mirrors
    ``repro_torch.api.register_strategy`` for ``train@strategy`` task
    ids).

    The decorated builder returns ``{param: StrategySpec}`` with the
    loss-data (batch) input as each obligation's *first* input — the
    scheduler transposes its sharding into the owed gradient collective.
    Reject unsupported degrees with ``ValueError`` (never ``assert``:
    the CLI maps ValueError to exit code 2, and a bare assert would exit
    1 — the code CI gates read as "bug localized")."""
    bug_specs = tuple(b if isinstance(b, BugSpec) else BugSpec(str(b))
                      for b in bugs)

    def deco(fn):
        if name in TRAIN_STRATEGIES:
            raise ValueError(f"train strategy `{name}` already registered")
        for s in TRAIN_STRATEGIES.values():
            taken = set(s.bug_names()) & {b.name for b in bug_specs}
            if taken:
                raise ValueError(f"train bug name(s) {sorted(taken)} "
                                 f"already registered under `{s.name}`")
        TRAIN_STRATEGIES[name] = TrainStrategy(
            name=name, params=tuple(params),
            degrees=tuple(normalize_degree(d) for d in degrees),
            bugs=bug_specs, bug_params=dict(bug_params or {}),
            description=description or (fn.__doc__ or "").strip().split("\n")[0],
            builder=fn)
        return fn

    return deco


def list_train_strategies() -> Tuple[str, ...]:
    return tuple(TRAIN_STRATEGIES)


def get_train_strategy(name: str) -> TrainStrategy:
    try:
        return TRAIN_STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown train strategy `{name}` — registered: "
                       f"{sorted(TRAIN_STRATEGIES)}") from None


def list_train_bugs() -> Dict[str, Tuple[str, BugSpec]]:
    """train bug name -> (host strategy, BugSpec)."""
    out: Dict[str, Tuple[str, BugSpec]] = {}
    for s in TRAIN_STRATEGIES.values():
        for b in s.bugs:
            out[b.name] = (s.name, b)
    return out


# ---------------------------------------------------------------------------
# dp — DDP: local backward + gradient psum
# ---------------------------------------------------------------------------

@register_train_strategy(
    "dp", degrees=(2, 4),
    description="DDP train step: batch-sharded local backward + grad psum")
def dp_train(degree: int = 2, bug=None) -> Dict[str, StrategySpec]:
    """Replicated parameters transpose to a gradient all-reduce: each rank
    runs the local backward on its batch shard and psums the result."""
    if degree < 1 or BATCH % degree:
        raise ValueError(f"train strategy `dp` needs the degree to divide "
                         f"the batch of {BATCH}, got degree {degree}")
    specs = (P("dp", None), P(), P())
    out = {}
    for param, a in _ARGNUM.items():
        seq_fn = grad_of(_loss, a)

        def dist_fn(x, w1, w2, a):
            g = grad_of(_loss, a)(x, w1, w2)
            return spmd.psum(g, "dp")

        out[param] = StrategySpec(seq_fn, _bound(dist_fn, a=a),
                                  {"dp": degree}, specs, _AVALS, _NAMES)
    return out


# ---------------------------------------------------------------------------
# dp_accum — DDP + microbatch accumulation into a dus scatter buffer
# ---------------------------------------------------------------------------

@register_train_strategy(
    "dp_accum", degrees=(2, 4),
    bugs=[BugSpec("accum_no_rescale", "refinement_error",
                  "the accumulated gradient is normalized by the "
                  "microbatch size instead of the global batch — grads "
                  "n_steps x too large (the HF-regression class)")],
    bug_params={"accum_no_rescale": "w2"},
    description="DDP + microbatch grad accumulation (dus scatter buffer)")
def dp_accum_train(degree: int = 2, bug=None) -> Dict[str, StrategySpec]:
    """Per-microbatch local backwards are written into a zeros scatter
    buffer (``dynamic_update_slice``), summed, psummed, and normalized by
    the *global* batch — verifiable end-to-end thanks to the constrained
    ``dus_concat`` lemma.  Bug ``accum_no_rescale`` (w2 only): the final
    normalization divides by the microbatch size."""
    local = BATCH // degree
    mb = local // N_MICRO
    if degree < 1 or BATCH % degree or mb < 1:
        raise ValueError(
            f"train strategy `dp_accum` needs degree * {N_MICRO} "
            f"microbatches to divide the batch of {BATCH}, got degree "
            f"{degree}")
    specs = (P("dp", None), P(), P())
    out = {}
    for param, a in _ARGNUM.items():
        def seq_fn(x, w1, w2, a):
            return grad_of(_loss, a)(x, w1, w2) / BATCH

        def dist_fn(x, w1, w2, a, param):
            gshape = _AVALS[a].shape
            buf = torch.zeros((N_MICRO,) + gshape, dtype=torch.float32,
                              device=x.device)
            for m in range(N_MICRO):
                xm = spmd.dynamic_slice(x, (m * mb, 0), (mb, D_MODEL))
                g = grad_of(_loss, a)(xm, w1, w2)
                buf = spmd.dynamic_update_slice(buf, g[None], (m, 0, 0))
            acc = torch.sum(buf, dim=0)
            tot = spmd.psum(acc, "dp")
            denom = mb if (bug == "accum_no_rescale" and param == "w2") \
                else BATCH               # BUG: microbatch-size normalization
            return tot / denom

        out[param] = StrategySpec(_bound(seq_fn, a=a),
                                  _bound(dist_fn, a=a, param=param),
                                  {"dp": degree}, specs, _AVALS, _NAMES)
    return out


# ---------------------------------------------------------------------------
# fsdp — ZeRO-3: gather weights forward, reduce_scatter gradients back
# ---------------------------------------------------------------------------

@register_train_strategy(
    "fsdp", degrees=(2, 4),
    bugs=[BugSpec("stale_grad_shard", "refinement_error",
                  "the gradient reduce_scatter is skipped — the rank keeps "
                  "its local partial's shard (stale ZeRO-3 shard class)")],
    bug_params={"stale_grad_shard": "w2"},
    description="ZeRO-3 train step: all_gather weights, reduce_scatter grads")
def fsdp_train(degree: int = 2, bug=None) -> Dict[str, StrategySpec]:
    """The all_gather of the forward transposes to a reduce_scatter of the
    backward: sum the per-rank partials over the group, keep your shard.
    Bug ``stale_grad_shard`` (w2 only): the scatter is skipped and the
    rank slices its own *unreduced* partial."""
    if degree < 1 or D_MODEL % degree or D_FF % degree \
            or BATCH % degree:
        raise ValueError(
            f"train strategy `fsdp` needs the degree to divide the "
            f"batch ({BATCH}) and both weight dims ({D_MODEL}, {D_FF}), "
            f"got degree {degree}")
    specs = (P("dp", None), P("dp", None), P("dp", None))
    out = {}
    for param, a in _ARGNUM.items():
        seq_fn = grad_of(_loss, a)

        def dist_fn(x, w1s, w2s, a, param):
            w1 = spmd.all_gather(w1s, "dp", axis=0, tiled=True)
            w2 = spmd.all_gather(w2s, "dp", axis=0, tiled=True)
            g = grad_of(_loss, a)(x, w1, w2)
            if bug == "stale_grad_shard" and param == "w2":
                blk = g.shape[0] // degree   # BUG: local partial, no reduce
                idx = spmd.axis_index("dp")
                return spmd.dynamic_slice(
                    g, (idx * blk, 0), (blk, g.shape[1]))
            return spmd.psum_scatter(g, "dp", scatter_dimension=0,
                                     tiled=True)

        out[param] = StrategySpec(seq_fn, _bound(dist_fn, a=a, param=param),
                                  {"dp": degree}, specs, _AVALS, _NAMES)
    return out


# ---------------------------------------------------------------------------
# tp_dp_2d — Megatron TP x DP: sharded-weight grads, dp-only psum
# ---------------------------------------------------------------------------

@register_train_strategy(
    "tp_dp_2d", degrees=((2, 2), (4, 4)),
    bugs=[BugSpec("grad_psum_wrong_axis", "refinement_error",
                  "the gradient all-reduce runs over tp instead of dp — "
                  "batch partials never combine and tp shards are wrongly "
                  "summed (the composed-mesh wrong-axis class)")],
    bug_params={"grad_psum_wrong_axis": "w2"},
    description="Megatron TP x DP train step: sharded-weight grads, dp psum")
def tp_dp_2d_train(degree=(2, 2), bug=None) -> Dict[str, StrategySpec]:
    """On the 2D mesh the weight shard is exact under transposition (the
    tp split of the forward concat transposes to the same split of the
    gradient), so each weight gradient owes a psum over *dp only*.  The
    16-rank ``(4, 4)`` mesh is exactly the add-chain width that needed the
    n-ary add normal form.  Bug ``grad_psum_wrong_axis`` (w2 only): the
    all-reduce runs over tp."""
    d_dp, d_tp = axis_degrees(degree, 2)
    if d_dp < 1 or d_tp < 1 or BATCH % d_dp or D_FF % d_tp:
        raise ValueError(
            f"train strategy `tp_dp_2d` needs dp to divide the batch "
            f"({BATCH}) and tp to divide d_ff ({D_FF}), got degree "
            f"({d_dp}, {d_tp})")
    specs = (P("dp", None), P(None, "tp"), P("tp", None))
    mesh = {"dp": d_dp, "tp": d_tp}
    out = {}
    for param, a in _ARGNUM.items():
        seq_fn = grad_of(_loss, a)

        def dist_fn(x, w1, w2, a, param):
            g = grad_of(_loss, a)(x, w1, w2)
            axis = "tp" if (bug == "grad_psum_wrong_axis"
                            and param == "w2") else "dp"   # BUG: wrong axis
            return spmd.psum(g, axis)

        out[param] = StrategySpec(seq_fn, _bound(dist_fn, a=a, param=param),
                                  mesh, specs, _AVALS, _NAMES)
    return out

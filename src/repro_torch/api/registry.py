"""Strategy registry: ``@register_strategy`` and spec construction.

The registry is the single source of truth for the verification case
matrix.  ``repro_torch.dist.strategies`` populates it at import time;
third-party code can add cases the same way without touching core:

    from repro_torch.api import register_strategy, BugSpec

    @register_strategy("my_case", bugs=[BugSpec("my_bug", "refinement_error")])
    def my_case(degree=2, bug=None):
        ...
        return StrategySpec(seq_fn, dist_fn, axes, specs, avals, names)

A registered builder returns a raw ``StrategySpec`` (or the 6-tuple,
which is normalized); the decorator wrapper stamps the
case name, degree, bug, and expectation metadata onto the spec and guards
against running a bug under the wrong host case (which would silently
verify the clean graph).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from .spec import BugSpec, Degree, StrategySpec, normalize_degree


@dataclass(frozen=True)
class RegisteredStrategy:
    """Registry entry: builder + task metadata for one strategy case."""
    name: str
    builder: Callable                    # (degree=, bug=, **kw) -> StrategySpec
    bugs: Tuple[BugSpec, ...]
    degrees: Tuple[Degree, ...]          # degrees the suite sweeps by default
                                         # (ints, or per-mesh-axis tuples)
    expected: str                        # clean-run expectation
    description: str = ""

    def bug_names(self) -> Tuple[str, ...]:
        return tuple(b.name for b in self.bugs)

    def validate_degree(self, degree: Degree) -> Degree:
        """Reject per-axis tuple degrees a case cannot take.

        The registered default ``degrees`` carry the case's shape: a case
        whose defaults are all ints is single-axis (its builder does int
        arithmetic on ``degree`` and would die with an opaque TypeError on
        a tuple); a multi-axis case declares tuple defaults whose arity a
        tuple override must match.  Scalars are always fine — multi-axis
        builders broadcast them over the mesh (``axis_degrees``).
        """
        degree = normalize_degree(degree)
        if isinstance(degree, tuple):
            arities = {len(d) for d in self.degrees if isinstance(d, tuple)}
            if not arities:
                raise ValueError(
                    f"case `{self.name}` is single-axis — it takes an int "
                    f"degree, not the per-axis tuple {degree}")
            if len(degree) not in arities:
                raise ValueError(
                    f"case `{self.name}` takes {sorted(arities)}-axis "
                    f"degrees, got {degree}")
        return degree

    def bug_spec(self, bug: str) -> BugSpec:
        for b in self.bugs:
            if b.name == bug:
                return b
        raise KeyError(bug)


_REGISTRY: Dict[str, RegisteredStrategy] = {}


class DuplicateStrategyError(ValueError):
    """A strategy (or one of its bug names) is already registered."""


def register_strategy(name: str, *, bugs=(),
                      degrees: Tuple[Degree, ...] = (2, 4),
                      expected: str = "certificate", description: str = ""):
    """Register a strategy builder under ``name``.

    ``bugs`` is a sequence of ``BugSpec`` (or plain bug-name strings, which
    default to ``expected="refinement_error"``).  ``expected`` states what
    the *clean* run should produce ("certificate", or "incomplete" for the
    documented completeness gaps).  ``degrees`` entries are ints or, for a
    multi-axis mesh, per-axis tuples like ``(4, 2)``.  The decorated
    function must accept ``degree=``, ``bug=`` and ``device=`` keywords (it
    makes its constants on ``device``) and return a ``StrategySpec`` (the
    6-tuple is accepted and normalized).
    """
    bug_specs = tuple(b if isinstance(b, BugSpec) else BugSpec(str(b))
                      for b in bugs)
    if expected not in ("certificate", "incomplete"):
        raise ValueError(f"clean expectation must be certificate or "
                         f"incomplete, got {expected!r}")

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise DuplicateStrategyError(
                f"strategy `{name}` is already registered "
                f"(by {_REGISTRY[name].builder.__module__})")
        for entry in _REGISTRY.values():
            taken = set(entry.bug_names()) & {b.name for b in bug_specs}
            if taken:
                # a shadowed bug name would re-host the bug and defeat the
                # wrong-host guard, silently verifying the clean graph
                raise DuplicateStrategyError(
                    f"bug name(s) {sorted(taken)} already registered under "
                    f"case `{entry.name}`")

        def build(degree: Degree = 2, bug: Optional[str] = None, **kw):
            degree = _REGISTRY[name].validate_degree(degree)
            if bug is not None and bug not in {b.name for b in bug_specs}:
                hosts = [entry.name for entry in _REGISTRY.values()
                         if bug in entry.bug_names()]
                raise ValueError(
                    f"bug `{bug}` belongs to case {hosts or '?'} — running "
                    f"it under `{name}` would silently verify the clean "
                    f"graph")
            raw = fn(degree=degree, bug=bug, **kw)
            if not isinstance(raw, StrategySpec):
                seq_fn, dist_fn, axes, specs, avals, names = raw
                raw = StrategySpec(seq_fn, dist_fn, axes, tuple(specs),
                                   tuple(avals), tuple(names))
            exp = expected if bug is None else \
                next(b.expected for b in bug_specs if b.name == bug)
            return raw.with_identity(
                name=name, degree=degree, bug=bug, expected=exp,
                description=description or (fn.__doc__ or "").strip())

        build.__name__ = fn.__name__
        build.__doc__ = fn.__doc__
        build.__wrapped__ = fn
        _REGISTRY[name] = RegisteredStrategy(
            name=name, builder=build, bugs=bug_specs,
            degrees=tuple(normalize_degree(d) for d in degrees),
            expected=expected,
            description=description or (fn.__doc__ or "").strip().split("\n")[0])
        return build

    return deco


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def _ensure_populated() -> None:
    """Strategies self-register on import; make lookups lazy-import them."""
    if not _REGISTRY:
        from ..dist import strategies  # noqa: F401  (import side effect)


def get_strategy(name: str) -> RegisteredStrategy:
    """Look up a registered strategy; KeyError names the known set."""
    _ensure_populated()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy `{name}` — registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_strategies() -> Tuple[str, ...]:
    """Registered case names, in registration order."""
    _ensure_populated()
    return tuple(_REGISTRY)


def list_bugs() -> Dict[str, Tuple[str, BugSpec]]:
    """bug name -> (host case name, BugSpec)."""
    _ensure_populated()
    out: Dict[str, Tuple[str, BugSpec]] = {}
    for entry in _REGISTRY.values():
        for b in entry.bugs:
            out[b.name] = (entry.name, b)
    return out


def bug_host(bug: str) -> str:
    """The case name hosting ``bug``; KeyError names the known bugs."""
    try:
        return list_bugs()[bug][0]
    except KeyError:
        raise KeyError(f"unknown bug `{bug}` — registered: "
                       f"{sorted(list_bugs())}") from None


def build_spec(name: str, *, degree: Degree = 2, bug: Optional[str] = None,
               device=None, **kw) -> StrategySpec:
    """Materialize one verification task from the registry, its constants
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for).

    Raises ``KeyError`` for an unknown case and ``ValueError`` when ``bug``
    is hosted by a different case (the wrong-host guard).
    """
    return get_strategy(name).builder(degree=degree, bug=bug, device=device,
                                      **kw)


# ---------------------------------------------------------------------------
# model-level tasks (repro_torch.modelcheck)
# ---------------------------------------------------------------------------
# Whole-model verification tasks live beside the strategy registry under
# ``model@plan`` ids (e.g. ``gpt@dp2xtp2``).  They are resolved lazily so
# importing ``repro_torch.api`` does not pull the model zoo in.

def list_model_tasks() -> Tuple[str, ...]:
    """``model@plan`` ids: every decomposable model x default mesh plan."""
    from ..modelcheck import supported_models
    from ..sharding.specs import DEFAULT_PLANS
    return tuple(f"{m}@{p}" for m in supported_models()
                 for p in DEFAULT_PLANS)


def check_model_task(task: str, **kw):
    """Run one ``model@plan`` whole-model task -> ``ModelReport``.

    Keyword arguments pass through to
    :func:`repro_torch.modelcheck.check_model` (``bug=``, ``bug_layer=``,
    ``workers=``, ``engine_opts=``, ``device=``, ...).
    """
    model, sep, plan = str(task).partition("@")
    if not sep or not model or not plan:
        raise KeyError(f"bad model task `{task}` — expected `model@plan` "
                       f"like `gpt@dp2xtp2`")
    from ..modelcheck import check_model
    return check_model(model, plan, **kw)


# ---------------------------------------------------------------------------
# train-step tasks (repro_torch.gradcheck)
# ---------------------------------------------------------------------------
# Training-step verification tasks live beside the case and ``model@plan``
# registries under ``train@strategy`` ids (e.g. ``train@dp_accum``) —
# resolved lazily so importing ``repro_torch.api`` does not pull gradcheck
# in.

def list_train_tasks() -> Tuple[str, ...]:
    """``train@strategy`` ids: every registered train-step strategy."""
    from ..gradcheck import list_train_strategies
    return tuple(f"train@{s}" for s in list_train_strategies())


def check_train_task(task: str, **kw):
    """Run one ``train@strategy`` train-step task -> ``TrainReport``.

    Keyword arguments pass through to
    :func:`repro_torch.gradcheck.check_train` (``degree=``, ``bug=``,
    ``workers=``, ``engine_opts=``, ``device=``, ...).
    """
    prefix, sep, strategy = str(task).partition("@")
    if not sep or prefix != "train" or not strategy:
        raise KeyError(f"bad train task `{task}` — expected "
                       f"`train@strategy` like `train@dp_accum`")
    from ..gradcheck import check_train
    return check_train(strategy, **kw)


# ---------------------------------------------------------------------------
# serving-path tasks
# ---------------------------------------------------------------------------

def list_serve_tasks() -> Tuple[str, ...]:
    """``serve@strategy`` ids: every registered serving strategy."""
    from ..servecheck import list_serve_strategies
    return tuple(f"serve@{s}" for s in list_serve_strategies())


def check_serve_task(task: str, **kw):
    """Run one ``serve@strategy`` serving-path task -> ``ServeReport``.

    Keyword arguments pass through to
    :func:`repro_torch.servecheck.check_serve` (``degree=``, ``bug=``,
    ``workers=``, ``engine_opts=``, ``device=``, ...).
    """
    prefix, sep, strategy = str(task).partition("@")
    if not sep or prefix != "serve" or not strategy:
        raise KeyError(f"bad serve task `{task}` — expected "
                       f"`serve@strategy` like `serve@tp_decode`")
    from ..servecheck import check_serve
    return check_serve(strategy, **kw)

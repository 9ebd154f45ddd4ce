"""Typed task model for the verification API.

``StrategySpec`` is the frozen, fully-materialized description of one
verification task: the sequential fragment G_s, the per-rank SPMD
implementation G_d, the mesh, the input sharding, and the identity /
expectation metadata the registry stamps on it.  It *iterates* as the
``(seq_fn, dist_fn, mesh_axes, in_specs, avals, names)`` 6-tuple:

    seq_fn, dist_fn, axes, specs, avals, names = build_spec("tp_layer")

``BugSpec`` describes one injectable bug class and how its detection
surfaces (paper §6.2): ``expected="refinement_error"`` bugs raise at a
localized operator; ``expected="unexpected_relation"`` bugs (paper bug 5)
produce a *clean but unexpected* certificate the user inspects.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

# A parallelism degree is either a single int (applied to every mesh axis)
# or a tuple with one entry per mesh axis, e.g. ``(4, 2)`` for a 2D
# ``{"dp": 4, "tp": 2}`` mesh.
Degree = Union[int, Tuple[int, ...]]

# Expectation vocabulary (also used by Report.verdict where applicable):
#   certificate          refinement holds, clean R_o certificate
#   incomplete           sound false alarm — documented completeness gap:
#                        the correct implementation raises RefinementError
#   refinement_error     injected bug is localized via RefinementError
#   unexpected_relation  clean certificate whose relation differs from the
#                        user's expectation (paper bug 5 detection mode)
EXPECTATIONS = ("certificate", "incomplete", "refinement_error",
                "unexpected_relation")

# What verdict ``verify()`` should produce for each expectation.
EXPECTED_VERDICT = {
    "certificate": "certificate",
    "incomplete": "refinement_error",
    "refinement_error": "refinement_error",
    "unexpected_relation": "certificate",
}


def normalize_degree(degree: Degree) -> Degree:
    """Canonical degree value: ints stay ints, sequences become tuples,
    and a 1-tuple collapses to its int (so JSON round-trips — where tuples
    come back as lists — and CLI parses agree on one representation)."""
    if isinstance(degree, (tuple, list)):
        t = tuple(int(d) for d in degree)
        return t[0] if len(t) == 1 else t
    return int(degree)


def degree_token(degree: Degree) -> str:
    """Stable string form of a degree: ``4`` -> "4", ``(2, 4)`` -> "2x4"."""
    degree = normalize_degree(degree)
    if isinstance(degree, tuple):
        return "x".join(str(d) for d in degree)
    return str(degree)


def parse_degree(token: str) -> Degree:
    """Inverse of :func:`degree_token` for CLI args: "4" -> 4,
    "2x4" -> (2, 4)."""
    try:
        parts = [int(p) for p in str(token).split("x")]
        if any(p < 1 for p in parts):
            raise ValueError(token)
        return normalize_degree(parts)
    except ValueError:
        raise ValueError(
            f"bad degree {token!r} — expected a positive int like `4` or a "
            f"per-axis tuple like `2x4`") from None


def axis_degrees(degree: Degree, n_axes: int) -> Tuple[int, ...]:
    """Per-axis view of a degree for an ``n_axes``-dimensional mesh: a
    scalar broadcasts to every axis, a tuple must match the axis count."""
    degree = normalize_degree(degree)
    if isinstance(degree, tuple):
        if len(degree) != n_axes:
            raise ValueError(
                f"degree {degree} has {len(degree)} entries for a "
                f"{n_axes}-axis mesh")
        return degree
    return (degree,) * n_axes


def task_id(case: str, degree: Degree, bug: Optional[str] = None) -> str:
    """The one stable matrix key: ``case@degN[+bug]`` (used by specs,
    reports, suite tasks, and the golden file alike).  Per-axis degrees
    render as ``case@degNxM``."""
    base = f"{case}@deg{degree_token(degree)}"
    return f"{base}+{bug}" if bug else base


class TensorSpec(NamedTuple):
    """Shape and ``torch.dtype`` of one global input (jax's
    ``ShapeDtypeStruct``); unpacks as ``(shape, dtype)``."""
    shape: Tuple[int, ...]
    dtype: Any


@dataclass(frozen=True)
class BugSpec:
    """One injectable bug class hosted by a strategy."""
    name: str
    expected: str = "refinement_error"   # or "unexpected_relation"
    description: str = ""

    def __post_init__(self):
        if self.expected not in ("refinement_error", "unexpected_relation"):
            raise ValueError(
                f"bug `{self.name}`: expected must be refinement_error or "
                f"unexpected_relation, got {self.expected!r}")

    @property
    def raises(self) -> bool:
        return self.expected == "refinement_error"


@dataclass(frozen=True)
class StrategySpec:
    """A fully-built verification task (one case at one degree, ± one bug).

    The first six fields mirror the legacy builder tuple; the rest is
    registry-stamped metadata.  Frozen: derive variants with
    ``dataclasses.replace``.
    """
    seq_fn: Callable
    dist_fn: Callable
    mesh_axes: Any                       # {axis name: parallelism degree}
    in_specs: Tuple[Any, ...]            # PartitionSpec per input -> R_i
    avals: Tuple[Any, ...]               # TensorSpec per global input
    input_names: Tuple[str, ...]
    # -- identity / expectation metadata (stamped by the registry) ----------
    name: str = ""
    degree: Degree = 0                   # int, or one entry per mesh axis
    bug: Optional[str] = None
    expected: str = "certificate"        # one of EXPECTATIONS
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "degree", normalize_degree(self.degree))
        object.__setattr__(self, "in_specs", tuple(self.in_specs))
        object.__setattr__(self, "avals", tuple(self.avals))
        object.__setattr__(self, "input_names", tuple(self.input_names))
        if self.expected not in EXPECTATIONS:
            raise ValueError(f"expected must be one of {EXPECTATIONS}, "
                             f"got {self.expected!r}")

    # -- legacy 6-tuple protocol -------------------------------------------
    def __iter__(self):
        yield self.seq_fn
        yield self.dist_fn
        yield self.mesh_axes
        yield list(self.in_specs)
        yield list(self.avals)
        yield list(self.input_names)

    def as_tuple(self):
        return tuple(self)

    # -----------------------------------------------------------------------
    @property
    def expected_verdict(self) -> str:
        return EXPECTED_VERDICT[self.expected]

    def with_identity(self, **kw) -> "StrategySpec":
        return replace(self, **kw)

    def task_id(self) -> str:
        return task_id(self.name, self.degree, self.bug)

"""Structured verification results.

``Report`` is the JSON-ready outcome of one ``verify()`` call — verdict,
the R_o certificate (stringified clean terms), the localization payload on
failure, and the engine's per-phase timers — replacing the CLI's
prints-and-exceptions surface.  The live ``Certificate`` object is attached
for in-process library use but never serialized (Terms are hash-consed and
deliberately not picklable), so reports cross process boundaries cheaply.

Verdicts:
    certificate        refinement holds; ``r_o`` carries the clean relation
    refinement_error   G_d does not (provably) refine G_s; ``localization``
                       names the operator (paper §6.2 debugging workflow)
    error              capture/engine failure (e.g. unsupported primitive)
    timeout            the suite runner gave up on the task
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

from .spec import Degree, normalize_degree, task_id

VERDICTS = ("certificate", "refinement_error", "error", "timeout")


@dataclass
class Report:
    """Outcome of verifying one (case, degree, bug) task."""
    case: str
    degree: Degree                       # int, or one entry per mesh axis
    bug: Optional[str]
    verdict: str                         # one of VERDICTS
    expected: str                        # registry expectation (spec.expected)
    ok: bool                             # verdict matches the expectation
    r_o: Optional[Dict[str, str]] = None        # G_s output -> clean Term str
    localization: Optional[Dict[str, Any]] = None
    stats: Optional[Dict[str, Any]] = None      # Certificate.stats (timers &c)
    error: Optional[str] = None
    wall_s: float = 0.0
    runtime: Optional[Dict[str, Any]] = None    # execution-layer facts
                                                # (cache hit, retries,
                                                # degraded_reason) — never
                                                # part of stable_summary
    explanation: Optional[Dict[str, Any]] = None  # proof provenance
                                                # (``--explain`` only): lemma
                                                # chain or failure frontier;
                                                # omitted from to_json when
                                                # absent and never part of
                                                # stable_summary
    certificate: Any = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        # tuple degrees arrive as lists after a JSON round trip
        self.degree = normalize_degree(self.degree)
        if self.verdict not in VERDICTS:
            raise ValueError(f"verdict must be one of {VERDICTS}, "
                             f"got {self.verdict!r}")

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        """JSON-safe dict (drops the live certificate object)."""
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name != "certificate"}
        if out.get("explanation") is None:
            # keep explain-off payloads byte-identical to pre-provenance ones
            out.pop("explanation")
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Report":
        allowed = {f.name for f in fields(cls)} - {"certificate"}
        return cls(**{k: v for k, v in d.items() if k in allowed})

    # -- stable views -------------------------------------------------------
    def task_id(self) -> str:
        return task_id(self.case, self.degree, self.bug)

    def stable_summary(self) -> dict:
        """Deterministic fields only (no timings) — golden-diff material."""
        out = {"verdict": self.verdict, "expected": self.expected,
               "ok": self.ok}
        if self.r_o is not None:
            out["r_o"] = dict(sorted(self.r_o.items()))
        if self.localization is not None:
            out["localization"] = {
                k: self.localization[k]
                for k in ("op_index", "op_name", "out_name")
                if k in self.localization}
        return out


_NAME = re.compile(r"\bt\d+\b")


def _bijective(pairs) -> bool:
    fwd, back = {}, {}
    return all(fwd.setdefault(x, y) == y and back.setdefault(y, x) == x
               for x, y in pairs)


def same_up_to_renaming(a: Dict[str, str], b: Dict[str, str]) -> bool:
    """True when two R_o maps (G_s output name -> clean term string) agree
    up to a consistent, one-to-one renaming of the ``t<N>`` tensor names —
    one renaming for the G_s names (the keys), one for the G_d names in the
    terms. Captures from jaxpr and from fx number their tensors
    differently; everything else (rank tags, ops, attributes) must match
    exactly."""
    if len(a) != len(b):
        return False
    for order in itertools.permutations(b.items()):
        keys, names = [], []
        for (ka, va), (kb, vb) in zip(a.items(), order):
            if _NAME.split(ka) != _NAME.split(kb) \
                    or _NAME.split(va) != _NAME.split(vb):
                break
            keys.append((ka, kb))
            names += zip(_NAME.findall(va), _NAME.findall(vb))
        else:
            if _bijective(keys) and _bijective(names):
                return True
    return False

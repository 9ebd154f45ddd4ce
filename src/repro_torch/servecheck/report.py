"""ServeReport: per-step decode verdicts stitched into one serving verdict.

Mirrors :class:`repro_torch.gradcheck.TrainReport` for the serving path: one
:class:`StepResult` per decode step (plus the prefill ``read``), each
backed by a nested :class:`repro_torch.api.Report` keyed by its obligation's
canonical key.  Steps in the same position class share an obligation, so
most step rows are ``cached`` — the dedup stats (``total_steps`` vs
``unique_obligations``) quantify the N-steps -> O(1)-obligations claim.
A bug run is ``ok`` only when the failure localizes to exactly the
injected step (its position-class siblings must stay clean).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

from ..api.spec import Degree, degree_token, normalize_degree

SERVE_REPORT_SCHEMA = 1

VERDICTS = ("certificate", "refinement_error", "unexpected_relation",
            "error")


@dataclass
class StepResult:
    """One decode step's (or the read's) obligation outcome."""
    step: str                    # "step0".."stepN-1" | "read"
    pos_class: str               # position class (the dedup identity)
    obligation: str              # canonical obligation key
    verdict: str                 # nested report's verdict
    relation_ok: bool            # inferred R_o == cache-spec relation
    cached: bool                 # an earlier step paid for this obligation
    localized_op: Optional[str] = None   # failing G_s operator, if any

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class ServeReport:
    """Serving-path refinement verdict for (strategy, degree[, bug])."""
    strategy: str
    degree: Degree
    verdict: str                         # one of VERDICTS
    ok: bool                             # matches the run's expectation
    steps: List[StepResult]
    reports: Dict[str, dict]             # obligation key -> nested Report
                                         # JSON (+ "seams" detail)
    total_steps: int = 0                 # decode steps + the read
    unique_obligations: int = 0
    dedup_ratio: float = 0.0
    failing_steps: List[str] = field(default_factory=list)
    bug: Optional[str] = None
    bug_step: Optional[int] = None       # the decode step the bug targets
    wall_s: float = 0.0
    workers: int = 0
    cache: Optional[dict] = None         # persistent-cache stats (hits,
                                         # misses, entries) — timing-class
                                         # data, never in stable_summary
    pool: Optional[dict] = None          # runtime pool_stats() aggregate
                                         # (queue-wait vs on-worker wall)
                                         # — timing-class data, never in
                                         # stable_summary
    explanation: Optional[dict] = None   # proof-provenance roll-up
                                         # (``--explain`` only); omitted
                                         # from to_json when absent, never
                                         # in stable_summary
    schema_version: int = SERVE_REPORT_SCHEMA

    def __post_init__(self):
        self.degree = normalize_degree(self.degree)
        if self.verdict not in VERDICTS:
            raise ValueError(f"verdict must be one of {VERDICTS}, "
                             f"got {self.verdict!r}")

    def task_id(self) -> str:
        base = f"serve@{self.strategy}@deg{degree_token(self.degree)}"
        return f"{base}+{self.bug}" if self.bug else base

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name != "steps"}
        if out.get("explanation") is None:
            out.pop("explanation")
        out["steps"] = [s.to_json() for s in self.steps]
        out["timing"] = self.timing()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ServeReport":
        allowed = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in allowed}
        kw["steps"] = [StepResult(**s) for s in d.get("steps", ())]
        return cls(**kw)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    # -- views --------------------------------------------------------------
    def timing(self) -> dict:
        """Per-phase wall time aggregated over the unique obligations."""
        phases: Dict[str, float] = {}
        infer_s = 0.0
        for rep in self.reports.values():
            stats = rep.get("stats") or {}
            infer_s += float(stats.get("time_s", 0.0))
            for k, v in (stats.get("phase_s") or {}).items():
                phases[k] = phases.get(k, 0.0) + float(v)
        return {
            "wall_s": round(self.wall_s, 6),
            "infer_s_sum": round(infer_s, 6),
            "phase_s_sum": {k: round(v, 6)
                            for k, v in sorted(phases.items())},
        }

    def stable_summary(self) -> dict:
        """Deterministic fields only — golden-diff material."""
        return {
            "verdict": self.verdict,
            "ok": self.ok,
            "failing_steps": list(self.failing_steps),
            "total_steps": self.total_steps,
            "unique_obligations": self.unique_obligations,
            "dedup_ratio": self.dedup_ratio,
            "steps": [{"step": s.step, "pos_class": s.pos_class,
                       "obligation": s.obligation, "verdict": s.verdict,
                       "relation_ok": s.relation_ok, "cached": s.cached}
                      for s in self.steps],
        }

    def to_markdown(self) -> str:
        lines = [
            f"### serve@{self.strategy} @ deg{degree_token(self.degree)}"
            + (f" (bug={self.bug}@step{self.bug_step})" if self.bug else ""),
            "",
            "| step | class | verdict | relation | cached | localized op |",
            "|------|-------|---------|----------|--------|--------------|",
        ]
        for s in self.steps:
            lines.append(
                f"| {s.step} | {s.pos_class} | {s.verdict} "
                f"| {'ok' if s.relation_ok else '**MISMATCH**'} "
                f"| {'yes' if s.cached else '-'} "
                f"| {s.localized_op or '-'} |")
        lines.append("")
        lines.append(
            f"**{self.verdict}** — {self.total_steps} serving block(s) "
            f"proved by {self.unique_obligations} obligation(s) "
            f"(dedup {self.dedup_ratio}x) in {self.wall_s:.2f}s.")
        if self.failing_steps:
            lines.append(f"Failing steps: {self.failing_steps}.")
        return "\n".join(lines)

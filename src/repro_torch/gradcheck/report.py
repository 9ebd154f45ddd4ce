"""TrainReport: per-parameter gradient verdicts stitched into one verdict.

Mirrors :class:`repro_torch.modelcheck.ModelReport` one level down: where the
model report nests per-*block* obligations, the train report nests one
:class:`repro_torch.api.Report` per *parameter* of the training step, plus the
transposition seam — the inferred gradient R_o must equal the relation
``expected_grad_relation`` derives from the parameter's PartitionSpec.
A bug run is ``ok`` only when the failure localizes to exactly the
injected parameter (every other parameter must stay clean).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

from ..api.spec import Degree, degree_token, normalize_degree

TRAIN_REPORT_SCHEMA = 1

VERDICTS = ("certificate", "refinement_error", "unexpected_relation",
            "error")


@dataclass
class ParamResult:
    """One parameter's gradient-obligation outcome."""
    param: str                   # "w1" | "w2" | ...
    verdict: str                 # nested report's verdict
    relation_ok: bool            # inferred R_o == transposed expectation
    collective: str              # owed collective: psum/reduce_scatter/...
    localized_op: Optional[str] = None   # failing G_s operator, if any

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class TrainReport:
    """Train-step refinement verdict for (strategy, degree[, bug])."""
    strategy: str
    degree: Degree
    verdict: str                         # one of VERDICTS
    ok: bool                             # matches the run's expectation
    params: List[ParamResult]
    reports: Dict[str, dict]             # param -> nested Report JSON
                                         # (+ "relation" detail)
    failing_params: List[str] = field(default_factory=list)
    bug: Optional[str] = None
    bug_param: Optional[str] = None      # the parameter the bug targets
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
    schema_version: int = TRAIN_REPORT_SCHEMA

    def __post_init__(self):
        self.degree = normalize_degree(self.degree)
        if self.verdict not in VERDICTS:
            raise ValueError(f"verdict must be one of {VERDICTS}, "
                             f"got {self.verdict!r}")

    def task_id(self) -> str:
        base = f"train@{self.strategy}@deg{degree_token(self.degree)}"
        return f"{base}+{self.bug}" if self.bug else base

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name != "params"}
        if out.get("explanation") is None:
            out.pop("explanation")
        out["params"] = [p.to_json() for p in self.params]
        out["timing"] = self.timing()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "TrainReport":
        allowed = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in allowed}
        kw["params"] = [ParamResult(**p) for p in d.get("params", ())]
        return cls(**kw)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    # -- views --------------------------------------------------------------
    def timing(self) -> dict:
        """Per-phase wall time aggregated over the parameter obligations."""
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
            "failing_params": list(self.failing_params),
            "params": [{"param": p.param, "verdict": p.verdict,
                        "relation_ok": p.relation_ok,
                        "collective": p.collective}
                       for p in self.params],
        }

    def to_markdown(self) -> str:
        lines = [
            f"### train@{self.strategy} @ deg{degree_token(self.degree)}"
            + (f" (bug={self.bug}@{self.bug_param})" if self.bug else ""),
            "",
            "| param | collective | verdict | relation | localized op |",
            "|-------|------------|---------|----------|--------------|",
        ]
        for p in self.params:
            lines.append(
                f"| {p.param} | {p.collective} | {p.verdict} "
                f"| {'ok' if p.relation_ok else '**MISMATCH**'} "
                f"| {p.localized_op or '-'} |")
        lines.append("")
        lines.append(
            f"**{self.verdict}** — {len(self.params)} parameter "
            f"gradient(s) checked in {self.wall_s:.2f}s.")
        if self.failing_params:
            lines.append(f"Failing parameters: {self.failing_params}.")
        return "\n".join(lines)

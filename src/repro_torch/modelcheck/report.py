"""ModelReport: per-obligation certificates stitched into one verdict.

A :class:`ModelReport` nests one :class:`repro_torch.api.Report` per *unique*
obligation (the dedup cache means N identical layers share a single nested
report — and therefore byte-identical certificates) plus the block-level
view that maps every model block back to its obligation, flags cache hits,
and localizes failures to block indices.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

MODEL_REPORT_SCHEMA = 1

VERDICTS = ("certificate", "refinement_error", "unexpected_relation",
            "error")


@dataclass
class BlockResult:
    """One model block's outcome (resolved through the dedup cache)."""
    index: int
    name: str                    # "embed" | "layer3" | "head"
    kind: str                    # obligation kind
    obligation: str              # canonical obligation key
    verdict: str                 # nested report's verdict
    cached: bool                 # True if another block already verified it
    seam_ok: bool                # inferred R_o == spec-promised relation

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class ModelReport:
    """Whole-model refinement verdict for (model, plan)."""
    model: str
    plan: str
    verdict: str                         # one of VERDICTS
    ok: bool                             # matches the run's expectation
    total_blocks: int
    unique_obligations: int
    dedup_ratio: float
    blocks: List[BlockResult]
    reports: Dict[str, dict]             # obligation key -> nested Report
                                         # JSON (+ "seams" detail)
    failing_blocks: List[int] = field(default_factory=list)
    bug: Optional[str] = None
    bug_layer: Optional[int] = None
    gs_ops_total: int = 0                # whole-model sequential op count
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
                                         # (``--explain`` only): per-
                                         # obligation step counts + lemma
                                         # sets; full chains stay on the
                                         # nested reports.  Omitted from
                                         # to_json when absent, never in
                                         # stable_summary
    schema_version: int = MODEL_REPORT_SCHEMA

    def __post_init__(self):
        if self.verdict not in VERDICTS:
            raise ValueError(f"verdict must be one of {VERDICTS}, "
                             f"got {self.verdict!r}")

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name != "blocks"}
        if out.get("explanation") is None:
            out.pop("explanation")
        out["blocks"] = [b.to_json() for b in self.blocks]
        out["timing"] = self.timing()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ModelReport":
        allowed = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in allowed}
        kw["blocks"] = [BlockResult(**b) for b in d.get("blocks", ())]
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
            "total_blocks": self.total_blocks,
            "unique_obligations": self.unique_obligations,
            "failing_blocks": list(self.failing_blocks),
            "blocks": [{"name": b.name, "verdict": b.verdict,
                        "cached": b.cached, "seam_ok": b.seam_ok}
                       for b in self.blocks],
        }

    def to_markdown(self) -> str:
        lines = [
            f"### {self.model} @ {self.plan}"
            + (f" (bug={self.bug}@layer{self.bug_layer})" if self.bug
               else ""),
            "",
            "| # | block | obligation | verdict | cached | seam |",
            "|--:|-------|------------|---------|--------|------|",
        ]
        for b in self.blocks:
            lines.append(
                f"| {b.index} | {b.name} | {b.obligation} | {b.verdict} "
                f"| {'hit' if b.cached else '-'} "
                f"| {'ok' if b.seam_ok else '**MISMATCH**'} |")
        lines.append("")
        lines.append(
            f"**{self.verdict}** — {self.unique_obligations} unique "
            f"obligation(s) for {self.total_blocks} blocks "
            f"(dedup {self.dedup_ratio:.1f}x) in {self.wall_s:.2f}s.")
        if self.failing_blocks:
            lines.append(f"Failing blocks: {self.failing_blocks}.")
        return "\n".join(lines)

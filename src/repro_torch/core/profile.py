"""Lightweight per-phase instrumentation + engine optimization toggles.

The inference hot path (saturate / rebuild / frontier / extract) is timed with
plain ``perf_counter`` accumulation — no context-manager overhead in the inner
loops. ``Certificate.stats["phase_s"]`` surfaces the accumulated seconds and
``stats["counters"]`` the dispatch/cache counters, so every benchmark run can
attribute wall time to a phase.

``OptConfig`` gates each of the engine optimizations independently so the
benchmark harness can measure the un-optimized baseline on the same commit
(``GRAPHGUARD_OPT=0 python benchmarks/run.py`` or
``set_optimizations(False)``):

  indexed_dispatch    op-indexed lemma table in ``EGraph.saturate`` instead of
                      scanning every lemma per pending node
  deferred_rebuild    congruence repair once per saturation round instead of
                      after every pending node
  incremental_extract worklist cost propagation + per-class cost cache keyed
                      on ``EGraph.version`` (re-extraction after no growth is
                      a dict lookup)
  indexed_frontier    leaf-name -> pending-def index with unmet-dependency
                      counts in ``GraphGuard._grow_frontier`` instead of
                      rescanning all pending G_d defs
  cached_nodes        canonical node sets of ``EGraph.nodes_of`` cached per
                      class, invalidated by union version + targeted pops

All toggles are behaviour-preserving: they change *when* work happens, never
which equalities hold, so certificates are identical either way (covered by
``tests/test_graphguard.py::test_optimizations_behaviour_preserving``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass
class OptConfig:
    """Engine optimization toggles (all on by default; certificates are
    byte-identical across settings).  Set via ``GRAPHGUARD_OPT`` or
    ``set_optimizations``."""
    indexed_dispatch: bool = True
    deferred_rebuild: bool = True
    incremental_extract: bool = True
    indexed_frontier: bool = True
    cached_nodes: bool = True

    @classmethod
    def from_env(cls) -> "OptConfig":
        on = os.environ.get("GRAPHGUARD_OPT", "1").lower() \
            not in ("0", "off", "false", "no")
        return cls(**{f.name: on for f in fields(cls)})

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


# Process-wide config (mutated in place so modules that imported CONFIG see
# toggles applied later, e.g. by the benchmark ablation section).
CONFIG = OptConfig.from_env()


def set_optimizations(enabled: bool, **overrides) -> None:
    """Toggle all engine optimizations (keyword args override per-flag)."""
    for f in fields(OptConfig):
        setattr(CONFIG, f.name, overrides.get(f.name, enabled))


def explain_enabled(override=None) -> bool:
    """Resolve the proof-provenance toggle: an explicit ``explain=`` engine
    option wins; otherwise ``GRAPHGUARD_EXPLAIN`` is the ambient default
    (inherited by spawn pool workers through the environment)."""
    if override is not None:
        return bool(override)
    return os.environ.get("GRAPHGUARD_EXPLAIN", "0").lower() \
        not in ("0", "off", "false", "no", "")


class Profile:
    """Accumulating per-phase timers and counters (all costs are adds)."""

    __slots__ = ("timers", "counters", "lemma_calls_by", "lemma_hits_by")

    def __init__(self):
        self.timers: dict[str, float] = {}
        self.counters: dict[str, int] = {}
        self.lemma_calls_by: dict[str, int] = {}
        self.lemma_hits_by: dict[str, int] = {}

    def add_time(self, phase: str, dt: float) -> None:
        self.timers[phase] = self.timers.get(phase, 0.0) + dt

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def count_lemma(self, name: str, hit: bool) -> None:
        """One lemma invocation (``hit``: it produced equalities)."""
        self.lemma_calls_by[name] = self.lemma_calls_by.get(name, 0) + 1
        if hit:
            self.lemma_hits_by[name] = self.lemma_hits_by.get(name, 0) + 1

    def lemma_stats(self, fire_counts: dict | None = None) -> dict:
        """Per-lemma calls/hits (+fires when collected), sorted by name.

        Deterministic across worker counts and tracing on/off — it is
        surfaced as ``Certificate.stats["lemmas"]``, which ships in the
        (cached, golden-diffed) certificate payload.
        """
        out: dict[str, dict] = {}
        for name in sorted(self.lemma_calls_by):
            out[name] = {"calls": self.lemma_calls_by[name],
                         "hits": self.lemma_hits_by.get(name, 0)}
            if fire_counts is not None:
                out[name]["fires"] = fire_counts.get(name, 0)
        return out

    def phase_seconds(self) -> dict:
        return dict(self.timers)

    def counter_values(self) -> dict:
        out = dict(self.counters)
        calls = out.get("lemma_calls", 0)
        if calls:
            out["lemma_hit_rate"] = round(out.get("lemma_hits", 0) / calls, 4)
        probes = out.get("extract_calls", 0)
        if probes:
            out["extract_cache_hit_rate"] = round(
                out.get("extract_cache_hits", 0) / probes, 4)
        return out

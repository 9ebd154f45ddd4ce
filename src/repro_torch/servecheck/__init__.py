"""repro_torch.servecheck — serving-path (sharded KV-cache decode) verification.

modelcheck proves the *training-shaped* forward, gradcheck the backward;
production inference runs a third program: incremental decode over a
sharded KV cache.  Its correctness argument — *N decode steps chained
over the cache refine full-sequence prefill* — is exactly a refinement
claim, and this subsystem verifies it:

    from repro_torch.servecheck import check_serve
    report = check_serve("tp_decode")             # -> ServeReport, on cuda
    report = check_serve("tp_decode", device="cpu")
    report = check_serve("sp_cache", bug="pos_off_by_one", degree=2)
    report.failing_steps                          # ["step4"] — localized

Pipeline:

  * ``relations``      derives the KV-cache PartitionSpec (and the clean
                       relation the seam check expects) from the same
                       :class:`MeshPlan` vocabulary modelcheck uses —
                       ``heads`` (feature-sharded, TP serving) and
                       ``seq`` (row-sharded, sequence-parallel cache)
                       layouts.
  * ``obligations``    the ``serve@strategy`` registry — per-decode-step
                       write obligations deduped by *position class*
                       (N steps -> O(1) obligations) plus one prefill
                       ``read`` obligation proving the chained steps
                       compose (the ``dus_concat``/``dus_unfold`` lemmas
                       flatten the update chain into the prefill concat),
                       for tp_decode, sp_cache and batched_decode, with
                       the three injected serving bug classes.
  * ``schedule``       fans unique obligations across the supervised
                       runtime pool, tracing each on the run's device
                       (persistent-cache keys
                       ``serve:{strategy}-{digest}``) and stitches
                       per-step reports into one :class:`ServeReport`.
  * ``report``         the nested, JSON-ready verdict (schema-versioned,
                       per-step localization + dedup stats).
"""
from .obligations import (SERVE_STRATEGIES, ServeStrategy,
                          get_serve_strategy, list_serve_bugs,
                          list_serve_strategies, register_serve_strategy)
from .relations import (CACHE_AXES, CACHE_LAYOUTS, cache_relation,
                        cache_rules, cache_spec, seq_parallel_plan)
from .report import SERVE_REPORT_SCHEMA, ServeReport, StepResult
from .schedule import check_serve, run_serve_obligations

__all__ = [
    "SERVE_STRATEGIES", "ServeStrategy", "get_serve_strategy",
    "list_serve_bugs", "list_serve_strategies", "register_serve_strategy",
    "CACHE_AXES", "CACHE_LAYOUTS", "cache_relation", "cache_rules",
    "cache_spec", "seq_parallel_plan",
    "SERVE_REPORT_SCHEMA", "ServeReport", "StepResult",
    "check_serve", "run_serve_obligations",
]

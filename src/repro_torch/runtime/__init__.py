"""repro_torch.runtime — fault-tolerant execution layer for the verifier.

The runtime under ``repro_torch.api.Suite`` and the ``--timeout``/``--cache``
flags of ``repro_torch.launch.verify``: a supervised worker pool (spawned
workers that reach the run's device, per-task budgets, heartbeat-based
hang/death telling, bounded retry with worker replacement, in-process
degradation), a crash-safe persistent certificate cache, and the chaos
harness that proves both.

    from repro_torch.runtime import RuntimeTask, SupervisedPool, run_tasks
    outcomes = run_tasks(tasks, workers=4, device="cuda",
                         cache=CertificateCache(dir))

Fault injection (the JAX package's variables):

    GRAPHGUARD_CHAOS=crash:1 GRAPHGUARD_CHAOS_TARGET=sp_moe ...
"""
from .cache import (CACHE_SCHEMA, DEFAULT_CACHE_DIR, CertificateCache,
                    aval_token, cacheable_report, engine_fingerprint,
                    resolve_cache, spec_token, strategy_cache_key)
from .pool import (PoolUnavailable, RuntimeTask, SupervisedPool,
                   TaskOutcome, execute_inline, pool_stats, run_tasks,
                   terminate_pool)
from . import chaos

__all__ = [
    "CACHE_SCHEMA", "DEFAULT_CACHE_DIR", "CertificateCache", "aval_token",
    "cacheable_report", "engine_fingerprint", "resolve_cache", "spec_token",
    "strategy_cache_key", "PoolUnavailable", "RuntimeTask",
    "SupervisedPool", "TaskOutcome", "execute_inline", "pool_stats",
    "run_tasks", "terminate_pool", "chaos",
]

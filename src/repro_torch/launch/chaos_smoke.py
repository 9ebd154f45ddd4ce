"""Chaos smoke: the port's twin of ``scripts/chaos_smoke.py`` — prove the
runtime's fault tolerance instead of asserting it (see
``repro_torch.runtime.chaos``).

    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke [--device cpu]

For each injected fault class the driver runs the same small suite matrix
under ``GRAPHGUARD_CHAOS``, with every pool spawned on ``--device``
(``cuda`` unless ``cpu`` is asked for; no CUDA device is an error, not a
fallback), and asserts the runtime's contract:

* the run completes and every task has a result (no lost tasks, no
  crashed driver);
* the afflicted task *alone* carries the fault verdict, with the cause
  attributed in its error string (``timeout`` + budget/heartbeat detail
  for hangs; ``error`` + worker exit cause for crashes/hard exits);
* every unafflicted task's certificate is byte-identical to the
  fault-free baseline, and its worker's ``task`` span is in the merged
  trace (a task that finished brings its span back with its result);
* a cache entry corrupted on commit is skipped and re-proved on the next
  run (``recovered_corrupt``), while undamaged entries hit;
* every injected fault is *visible* in a recorded trace — the supervisor
  emits ``cat: "fault"`` events (``pool.broken``/``task.retry`` for kill
  faults, ``task.timeout`` for hangs, ``chaos.corrupt_cache`` for cache
  corruption).

Exit code 0 only if every assertion holds. ``run(device)`` returns the
failed checks (empty when all pass).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

from .cache_smoke import report
from .explain_smoke import Checks

CASES = ("tp_layer", "sp_rope", "ep_moe", "sp_moe")
DEGREES = (2,)
WORKERS = 2
BUDGET_S = 20.0                          # generous for clean sub-second
HANG_BUDGET_S = 4.0                      # tasks; tight for the hang run
KILL_FAULTS = ("pool.broken", "task.retry", "worker.crash", "task.failed")


def set_chaos(spec=None, target=""):
    """Set (or, with ``spec`` None, clear) the chaos variables; a pool
    started afterwards inherits them."""
    from ..runtime.chaos import ENV_SEED, ENV_SPEC, ENV_TARGET
    for var in (ENV_SPEC, ENV_TARGET, ENV_SEED):
        os.environ.pop(var, None)
    if spec is not None:
        os.environ[ENV_SPEC] = spec
        os.environ[ENV_TARGET] = target


def worker_span_keys(tracer) -> set:
    """The task keys of the workers' ``task`` spans in a merged trace."""
    return {e["args"]["key"] for e in tracer.events
            if e.get("name") == "task" and e.get("ph") == "X"
            and e["pid"] != tracer.pid}


def run(device=None) -> list:
    """Every fault class on ``device``; returns the failed checks."""
    from ..api import Suite
    from ..obs import trace as obs_trace
    from ..runtime import CertificateCache

    check = Checks("chaos-smoke")

    def run_suite(timeout_s=BUDGET_S, cache=None):
        with Suite(cases=CASES, degrees=DEGREES) as suite:
            return suite.run(workers=WORKERS, timeout_s=timeout_s,
                             cache=cache if cache is not None else False,
                             device=device)

    def traced_run(**kw):
        tracer = obs_trace.start("chaos-smoke")
        try:
            return run_suite(**kw), tracer
        finally:
            obs_trace.stop()

    def fault_visible(tracer, names, scenario):
        seen = {e["name"] for e in tracer.events if e.get("cat") == "fault"}
        check(bool(seen & set(names)),
              f"{scenario} fault visible in trace (want one of "
              f"{sorted(names)}, fault events: {sorted(seen)})")

    def survivors_identical(result, victim, tracer=None):
        base, got = baseline.stable_summary(), result.stable_summary()
        clean = [k for k in base if k != victim]
        check(all(json.dumps(base[k], sort_keys=True)
                  == json.dumps(got[k], sort_keys=True) for k in clean),
              f"{len(clean)} unafflicted tasks byte-identical to baseline")
        if tracer is not None:
            ran = worker_span_keys(tracer)
            check(set(clean) <= ran and victim not in ran,
                  f"every unafflicted task's worker span in the trace, "
                  f"the victim's not (spans: {sorted(ran)})")

    set_chaos(None)
    print(f"[chaos-smoke] baseline: {len(CASES)} cases @ deg2, "
          f"{WORKERS} workers")
    baseline = run_suite()
    check(baseline.ok, "fault-free baseline is clean")
    victim = f"{CASES[0]}@deg2"
    try:
        for mode, cause in (("crash", "SIGSEGV"), ("exit", "exit code 3")):
            print(f"[chaos-smoke] {mode}:1 targeting {victim}")
            set_chaos(f"{mode}:1", victim)
            res, tracer = traced_run()
            rep = {r.task_id(): r for r in res}[victim]
            check(len(res) == len(baseline), "every task has a result")
            check(rep.verdict == "error",
                  f"victim verdict is error (got {rep.verdict})")
            check(cause in (rep.error or ""),
                  f"exit cause attributed in error: {rep.error!r}")
            check((rep.runtime or {}).get("attempts", 1) > 1,
                  f"bounded retries recorded: {rep.runtime}")
            survivors_identical(res, victim, tracer)
            fault_visible(tracer, KILL_FAULTS, mode)

        print(f"[chaos-smoke] hang:1 targeting {victim} "
              f"({HANG_BUDGET_S:g}s budget)")
        set_chaos("hang:1", victim)
        res, tracer = traced_run(timeout_s=HANG_BUDGET_S)
        rep = {r.task_id(): r for r in res}[victim]
        check(rep.verdict == "timeout",
              f"victim verdict is timeout (got {rep.verdict})")
        check("budget" in (rep.error or ""),
              f"budget overrun attributed in error: {rep.error!r}")
        check(rep.wall_s >= HANG_BUDGET_S * 0.9,
              f"measured elapsed recorded, not the nominal budget "
              f"({rep.wall_s:.2f}s)")
        survivors_identical(res, victim, tracer)
        fault_visible(tracer, ("task.timeout",), "hang")

        print(f"[chaos-smoke] corrupt_cache:1 targeting {CASES[0]} "
              f"(byte flipped on commit)")
        cache_dir = tempfile.mkdtemp(prefix="graphguard-torch-chaos-cache-")
        try:
            set_chaos("corrupt_cache:1", CASES[0])
            res, tracer = traced_run(cache=cache_dir)
            check(res.ok, "run with corrupting cache still verifies cleanly")
            fault_visible(tracer, ("chaos.corrupt_cache",), "corrupt_cache")
            set_chaos(None)
            cache = CertificateCache(cache_dir)
            check(cache.recovered_corrupt >= 1,
                  f"corrupt journal entry skipped on reload "
                  f"({cache.recovered_corrupt} recovered)")
            res2 = run_suite(cache=cache)
            check(res2.cache["hits"] == len(baseline) - 1
                  and res2.cache["misses"] == 1,
                  f"only the damaged entry re-proved (hits="
                  f"{res2.cache['hits']}, misses={res2.cache['misses']})")
            survivors_identical(res2, None)
        finally:
            shutil.rmtree(cache_dir, ignore_errors=True)
    finally:
        set_chaos(None)
    return check.failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.chaos_smoke",
        description="Chaos smoke: injected worker and cache faults must be "
                    "contained and attributed.")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where every pool runs (default: cuda, which must "
                         "exist)")
    return report("chaos-smoke", run(ap.parse_args(argv).device),
                  "every injected fault was contained, attributed, and "
                  "survived with byte-identical certificates")


if __name__ == "__main__":
    sys.exit(main())

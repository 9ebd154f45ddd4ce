"""Persistent-cache smoke: the port's twin of ``scripts/cache_smoke.py`` —
cold vs warm re-verification (see ``repro_torch.runtime.cache``).

    PYTHONPATH=src python -m repro_torch.launch.cache_smoke [--device cpu]

Asserts the cache's contract end to end on real verification work, with
every pool spawned on ``--device`` (``cuda`` unless ``cpu`` is asked for;
no CUDA device is an error, not a fallback):

* a cold suite run commits every deterministic verdict (all misses);
* a warm re-run serves every task from the journal (all hits) with
  byte-identical stable summaries (verdicts + R_o certificates);
* a torn tail line (the crash-mid-append case) is skipped on reload and
  only that entry is re-proved;
* the whole-model path (``gpt@dp2xtp2``) re-verifies warm via
  ``canonical_key`` content addressing, and the measured cold/warm walls
  are printed.

Exit code 0 only if every assertion holds. ``run(device)`` returns the
failed checks (empty when all pass).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from .explain_smoke import Checks

CASES = ("tp_layer", "sp_rope", "ep_moe", "sp_moe")
DEGREES = (2,)
WORKERS = 2


def _stable(result) -> str:
    return json.dumps(result.stable_summary(), sort_keys=True)


def run(device=None) -> list:
    """Every leg on ``device``; returns the failed checks."""
    from ..api import Suite
    from ..modelcheck import check_model
    from ..runtime import CertificateCache
    from ..runtime.chaos import ENV_SPEC

    check = Checks("cache-smoke")

    def run_suite(cache):
        with Suite(cases=CASES, degrees=DEGREES) as suite:
            return suite.run(workers=WORKERS, timeout_s=60.0, cache=cache,
                             device=device)

    os.environ.pop(ENV_SPEC, None)
    cache_dir = tempfile.mkdtemp(prefix="graphguard-torch-cache-smoke-")
    try:
        n = len(CASES)
        print(f"[cache-smoke] suite: {n} cases @ deg2, cache {cache_dir}")
        cold = run_suite(cache_dir)
        check(cold.ok, "cold run verifies cleanly")
        check(cold.cache["misses"] == n and cold.cache["hits"] == 0,
              f"cold run commits everything (misses={cold.cache['misses']})")

        warm = run_suite(cache_dir)
        check(warm.cache["hits"] == n and warm.cache["misses"] == 0,
              f"warm run all hits (hits={warm.cache['hits']})")
        check(_stable(cold) == _stable(warm),
              "warm certificates byte-identical to cold")

        # crash-mid-append: tear the journal's last line in half — the
        # reload must skip it and the next run re-proves only that entry
        journal = CertificateCache(cache_dir).journal_path
        with open(journal, "rb") as f:
            lines = f.readlines()
        with open(journal, "wb") as f:
            f.writelines(lines[:-1])
            f.write(lines[-1][:len(lines[-1]) // 2])
        cache = CertificateCache(cache_dir)
        check(cache.recovered_corrupt == 1,
              f"torn tail line skipped on reload "
              f"({cache.recovered_corrupt} recovered)")
        resumed = run_suite(cache)
        check(resumed.cache["hits"] == n - 1
              and resumed.cache["misses"] == 1,
              f"resume re-proves only the torn entry "
              f"(hits={resumed.cache['hits']}, "
              f"misses={resumed.cache['misses']})")
        check(_stable(cold) == _stable(resumed),
              "resumed certificates byte-identical to cold")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    # whole-model path: obligation-level content addressing
    model_dir = tempfile.mkdtemp(prefix="graphguard-torch-cache-smoke-model-")
    try:
        print("[cache-smoke] modelcheck: gpt@dp2xtp2 cold vs warm")
        t0 = time.perf_counter()
        cold_m = check_model("gpt", "dp2xtp2", cache=model_dir,
                             device=device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm_m = check_model("gpt", "dp2xtp2", cache=model_dir,
                             device=device)
        warm_s = time.perf_counter() - t0
        check(cold_m.verdict == "certificate" and cold_m.cache["hits"] == 0,
              f"cold model check proves all "
              f"{cold_m.cache['misses']} obligations")
        check(warm_m.verdict == "certificate"
              and warm_m.cache["misses"] == 0
              and warm_m.cache["hits"] == cold_m.cache["misses"],
              f"warm model check all hits (hits={warm_m.cache['hits']})")
        check(_stable(cold_m) == _stable(warm_m),
              "warm model verdicts byte-identical to cold")
        print(f"[cache-smoke] gpt@dp2xtp2 wall: cold {cold_s * 1e3:.0f} ms, "
              f"warm {warm_s * 1e3:.0f} ms "
              f"({cold_s / max(warm_s, 1e-9):.1f}x)")
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    return check.failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cache_smoke",
        description="Persistent-cache smoke: cold vs warm re-verification.")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where every pool and check runs (default: cuda, "
                         "which must exist)")
    return report("cache-smoke", run(ap.parse_args(argv).device),
                  "cold commits, warm hits, torn entries recovered, "
                  "certificates byte-identical throughout")


def report(tag: str, failures: list, passed: str) -> int:
    """Print a smoke's verdict; its exit code (0 when nothing failed)."""
    if failures:
        print(f"[{tag}] FAILED: {len(failures)} assertion(s):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"[{tag}] PASS: {passed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

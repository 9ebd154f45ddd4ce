"""``Suite`` — fan a (cases × degrees × bugs) matrix across a process pool.

    from repro_torch.api import Suite
    result = Suite(degrees=(2,)).run(workers=4)          # clean, on cuda
    result = Suite(include_bugs=True).run(device="cpu")  # + all hosted bugs
    print(result.to_markdown()); result.write("suite.json")

Semantics:

* Tasks are the cross product of ``cases`` × ``degrees``, each case's
  hosted bugs riding along when ``include_bugs`` (bugs only run under the
  degrees their host case supports).
* ``device`` is resolved once, in the caller, before any worker starts:
  ``None`` means ``cuda``, and without a card the run raises there rather
  than answering every task with an error.  Every task traces on it.
* ``run(workers=0)`` (or 1) executes in-process sequentially;
  ``workers >= 2`` fans out on the shared fault-tolerant runtime
  (:mod:`repro_torch.runtime`): a supervised pool of *spawned* workers
  (each makes its own CUDA context) that persists on the Suite instance
  across ``run`` calls — call ``shutdown()`` or use the Suite as a context
  manager to release them.  Workers receive only ``(case, degree, bug)``
  name triples, the device and the module that registered the case, and
  rebuild specs from the registry, so nothing unpicklable crosses the
  boundary.  A case registered by a module a worker cannot import (such as
  ``__main__``) raises before anything is submitted.
* Results are ordered by the task matrix — never by completion order —
  and the engine's deterministic tie-breaks make certificates (the
  ``r_o`` strings) byte-identical for any worker count.
* ``timeout_s`` is the *per-task* budget.  On pool runs the runtime
  enforces it from the moment the task starts on a worker (heartbeat
  tracked), reports the offender as ``verdict="timeout"`` with its
  measured elapsed time, kills the wedged worker with its pool, and
  resumes the rest on a replacement pool.  A crashed worker quarantines
  the tasks it was running onto bounded retries with the exit cause
  recorded in the error string; a pool that cannot be rebuilt degrades to
  in-process execution, on the same device, with a structured
  ``degraded_reason`` in every affected Report.  In-process sequential
  runs cannot interrupt themselves, so budgets are not enforced there.
* ``cache=`` attaches the persistent certificate cache
  (:class:`repro_torch.runtime.CertificateCache`): deterministic verdicts
  are committed as they complete, repeat tasks are served as cache hits
  with byte-identical certificates, and an interrupted run resumes from
  its last committed task.

CLI:

    python -m repro_torch.api [--cases ...] [--degrees 2 4] [--bugs]
        [--device cuda|cpu] [--workers N] [--timeout S]
        [--cache [DIR] | --no-cache] [--json PATH] [--markdown PATH]
        [--check GOLDEN] [--write-golden PATH]

``--check`` holds verdicts, expectations and localizations exactly and
R_o up to a renaming of ``t<N>`` tensor names
(:func:`~repro_torch.api.report.same_up_to_renaming`), so the JAX
package's golden ``tests/golden/suite_degree2.json`` checks the port.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..models.registry import resolve_device
from ..runtime import (DEFAULT_CACHE_DIR, RuntimeTask, SupervisedPool,
                       execute_inline, pool_stats, resolve_cache,
                       strategy_cache_key)
from .registry import build_spec, get_strategy, list_bugs, list_strategies
from .report import Report, same_up_to_renaming
from .runner import verify
from .spec import Degree, normalize_degree, parse_degree
from .spec import task_id as spec_task_id

# the module whose import registers the built-in cases
_BUILTIN = "repro_torch.dist.strategies"


@dataclass(frozen=True)
class SuiteTask:
    """One cell of the suite matrix: (case, degree, optional bug)."""
    case: str
    degree: Degree                       # int, or one entry per mesh axis
    bug: Optional[str] = None

    def task_id(self) -> str:
        return spec_task_id(self.case, self.degree, self.bug)


def _run_task(task: tuple, engine_opts: Optional[dict], device: str,
              module: str = _BUILTIN) -> dict:
    """Pool worker: import the module that registers the case, rebuild
    the spec by name on ``device`` and return a JSON-ready dict."""
    importlib.import_module(module)
    case, degree, bug = task
    return verify(case, degree=degree, bug=bug, engine_opts=engine_opts,
                  device=device).to_json()


def registering_module(case: str) -> str:
    """The module a spawned worker must import to know ``case``.

    Raises ``ValueError`` when no worker could import it (the entry was
    registered in ``__main__`` or in a module that is not on the import
    path), so the mistake surfaces once in the caller, not as a verdict.
    """
    module = get_strategy(case).builder.__wrapped__.__module__
    if module in ("__main__", "__mp_main__") \
            or importlib.util.find_spec(module) is None:
        raise ValueError(
            f"case `{case}` was registered by module `{module}`, which a "
            f"spawned worker cannot import; register it in an importable "
            f"module, or run with workers=0")
    return module


class SuiteResult:
    """Ordered reports + aggregation to JSON / Markdown."""

    def __init__(self, reports: List[Report], wall_s: float, workers: int,
                 cache: Optional[dict] = None,
                 runtime: Optional[dict] = None):
        self.reports = reports
        self.wall_s = wall_s
        self.workers = workers
        self.cache = cache               # persistent-cache stats, if used
        self.runtime = runtime           # pool_stats() aggregate

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.reports)

    def __iter__(self):
        return iter(self.reports)

    def __len__(self):
        return len(self.reports)

    def summary(self) -> dict:
        verdicts: Dict[str, int] = {}
        for r in self.reports:
            verdicts[r.verdict] = verdicts.get(r.verdict, 0) + 1
        out = {
            "total": len(self.reports),
            "ok": sum(r.ok for r in self.reports),
            "not_ok": [r.task_id() for r in self.reports if not r.ok],
            "verdicts": dict(sorted(verdicts.items())),
            "wall_s": round(self.wall_s, 3),
            "workers": self.workers,
        }
        if self.cache is not None:
            out["cache"] = self.cache
        if self.runtime is not None:
            # queue-wait vs on-worker wall aggregate (pool_stats) —
            # timing-class, so never in stable_summary()
            out["runtime"] = self.runtime
        return out

    def stable_summary(self) -> dict:
        """Timing-free view keyed by task id — the golden-diff artifact."""
        return {r.task_id(): r.stable_summary() for r in self.reports}

    def to_json(self) -> dict:
        return {
            "schema": 1,
            "summary": self.summary(),
            "reports": [r.to_json() for r in self.reports],
        }

    def to_markdown(self) -> str:
        lines = [
            "| task | verdict | expected | ok | wall ms |",
            "|------|---------|----------|----|--------:|",
        ]
        for r in self.reports:
            lines.append(
                f"| {r.task_id()} | {r.verdict} | {r.expected} "
                f"| {'yes' if r.ok else '**NO**'} | {r.wall_s * 1e3:.1f} |")
        s = self.summary()
        lines.append("")
        lines.append(f"{s['ok']}/{s['total']} tasks matched expectation in "
                     f"{s['wall_s']:.2f}s ({s['workers']} workers).")
        if self.cache is not None:
            lines.append(f"Certificate cache: {self.cache['hits']} hit(s), "
                         f"{self.cache['misses']} miss(es) "
                         f"({self.cache['dir']}).")
        return "\n".join(lines)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)


class Suite:
    """A verification task matrix with a fault-tolerant parallel runner."""

    def __init__(self, cases: Optional[Sequence[str]] = None,
                 degrees: Optional[Sequence[Degree]] = None,
                 include_bugs: bool = False,
                 bugs: Optional[Sequence[str]] = None,
                 engine_opts: Optional[dict] = None):
        self.cases = tuple(cases) if cases is not None else list_strategies()
        for c in self.cases:
            get_strategy(c)              # fail fast on unknown names
        self.degrees = tuple(normalize_degree(d) for d in degrees) \
            if degrees is not None else None
        if self.degrees is not None:
            for c in self.cases:         # fail fast: a tuple degree on a
                for d in self.degrees:   # single-axis case would abort the
                    get_strategy(c).validate_degree(d)  # run mid-matrix
        self.include_bugs = include_bugs or bugs is not None
        self.bugs = tuple(bugs) if bugs is not None else None
        if self.bugs:
            hosted = list_bugs()
            for b in self.bugs:          # fail fast: a typo would otherwise
                if b not in hosted:      # silently yield zero bug tasks
                    raise KeyError(f"unknown bug `{b}` — registered: "
                                   f"{sorted(hosted)}")
                if hosted[b][0] not in self.cases:
                    raise ValueError(
                        f"bug `{b}` is hosted by case `{hosted[b][0]}`, "
                        f"which is not in this suite's cases — it would "
                        f"never run")
        self.engine_opts = engine_opts
        self._pool: Optional[SupervisedPool] = None

    def tasks(self) -> List[SuiteTask]:
        out: List[SuiteTask] = []
        for case in self.cases:
            entry = get_strategy(case)
            degrees = self.degrees if self.degrees is not None \
                else entry.degrees
            for deg in degrees:
                out.append(SuiteTask(case, deg))
                if not self.include_bugs:
                    continue
                for b in entry.bugs:
                    if self.bugs is not None and b.name not in self.bugs:
                        continue
                    out.append(SuiteTask(case, deg, b.name))
        return out

    # -- execution ----------------------------------------------------------
    def run(self, workers: Optional[int] = None, timeout_s: float = 120.0,
            cache=None, device=None) -> SuiteResult:
        """Run the matrix on ``device`` (``cuda`` unless ``"cpu"`` is asked
        for); ``cache`` takes anything
        :func:`repro_torch.runtime.resolve_cache` accepts (a directory
        path, an open :class:`CertificateCache`, True for the default
        location, None to consult ``$GRAPHGUARD_TORCH_CACHE_DIR``)."""
        device = str(resolve_device(device))
        tasks = self.tasks()
        if workers is None:
            workers = min(4, len(tasks)) or 1
        modules = {} if workers <= 1 else \
            {c: registering_module(c) for c in {t.case for t in tasks}}
        cache = resolve_cache(cache)
        t0 = time.perf_counter()
        rts = [self._runtime_task(t, timeout_s, cache, device,
                                  modules.get(t.case, _BUILTIN))
               for t in tasks]
        if workers <= 1:
            outcomes = execute_inline(rts, cache=cache)
        else:
            outcomes = self._get_pool(min(workers, len(rts)) or 1,
                                      device).execute(rts, cache=cache)
        reports = [Report.from_json(outcome_report(
            t.case, t.degree, t.bug, outcomes[t.task_id()])) for t in tasks]
        hits = sum(1 for o in outcomes.values() if o.cache == "hit")
        misses = sum(1 for o in outcomes.values() if o.cache == "miss")
        cache_stats = None if cache is None else \
            {"dir": cache.dir, "hits": hits, "misses": misses,
             "entries": len(cache),
             "recovered_corrupt": cache.recovered_corrupt}
        return SuiteResult(reports, time.perf_counter() - t0, workers,
                           cache=cache_stats, runtime=pool_stats(outcomes))

    def _runtime_task(self, task: SuiteTask, timeout_s: float, cache,
                      device: str, module: str) -> RuntimeTask:
        cache_key = None
        if cache is not None:
            # content-addressed: mesh + shapes + dtypes + input specs, so
            # an edited strategy re-proves while untouched ones hit
            cache_key = strategy_cache_key(
                build_spec(task.case, degree=task.degree, bug=task.bug,
                           device=device),
                self.engine_opts)
        return RuntimeTask(
            key=task.task_id(), fn=_run_task,
            args=((task.case, task.degree, task.bug), self.engine_opts,
                  device, module),
            budget_s=timeout_s, cache_key=cache_key)

    # -- pool lifecycle -----------------------------------------------------
    def _get_pool(self, workers: int, device: str) -> SupervisedPool:
        """Create (or reuse) the supervised worker pool.

        The pool persists on the Suite instance across ``run`` calls with
        the same worker count and device: a spawned worker's start-up
        (interpreter, torch import, CUDA context) is paid once.  Call
        :meth:`shutdown` (or use the Suite as a context manager) to
        release the processes.
        """
        if self._pool is not None and (self._pool.workers != workers
                                       or self._pool.device != device):
            self.shutdown()
        if self._pool is None:
            self._pool = SupervisedPool(workers, device=device)
        return self._pool

    def shutdown(self) -> None:
        """Release the pool without blocking on wedged workers (see
        :func:`repro_torch.runtime.terminate_pool`)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "Suite":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _expected(case: str, bug: Optional[str]) -> str:
    entry = get_strategy(case)
    if bug is None:
        return entry.expected
    return entry.bug_spec(bug).expected


def outcome_report(case: str, degree: Degree, bug: Optional[str],
                   outcome) -> dict:
    """A Report-shaped dict for one runtime outcome: the worker's report
    (with any runtime facts attached) when it ran, else a ``timeout`` or
    ``error`` verdict charged to exactly this task."""
    if outcome.ok:
        d = dict(outcome.value)
        info = outcome.runtime_info()
        if info:
            d["runtime"] = info
        return d
    return Report(
        case=case, degree=degree, bug=bug,
        verdict="timeout" if outcome.status == "timeout" else "error",
        expected=_expected(case, bug), ok=False, error=outcome.error,
        wall_s=round(outcome.wall_s, 6),
        runtime=outcome.runtime_info() or None).to_json()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

# The JAX package's checked-in CI golden (the clean degree-2 matrix's
# stable summary): ``--check`` diffs the port against it; the port's
# regenerator writes elsewhere and never over it.
REFERENCE_GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "tests", "golden",
    "suite_degree2.json")
GOLDEN_DEGREES = (2,)


def update_golden(path: str, workers: int = 4, timeout_s: float = 120.0,
                  device=None) -> int:
    """Deterministically regenerate the clean degree-2 matrix's golden
    into ``path`` (the counterpart of the JAX package's ``update_golden``).

    Certificates are byte-identical for any worker count, so the output
    depends only on the registered strategies.  A matrix that misses its
    own expectations is refused — a golden must never encode a failing
    suite — and so is the reference's golden, :data:`REFERENCE_GOLDEN`.
    """
    if os.path.realpath(path) == os.path.realpath(REFERENCE_GOLDEN):
        print(f"[suite] REFUSING to write golden: {path} is the JAX "
              f"package's golden, which --check holds the port to",
              file=sys.stderr)
        return 2
    with Suite(degrees=GOLDEN_DEGREES) as suite:
        result = suite.run(workers=workers, timeout_s=timeout_s,
                           device=device)
    if not result.ok:
        print(f"[suite] REFUSING to write golden: tasks missed their "
              f"expectation: {result.summary()['not_ok']}", file=sys.stderr)
        return 1
    with open(path, "w") as f:
        json.dump(result.stable_summary(), f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"[suite] regenerated golden {path} ({len(result)} tasks)",
          file=sys.stderr)
    return 0


def add_cache_flags(ap: argparse.ArgumentParser) -> None:
    """The shared --cache/--no-cache pair (also used by launch/verify)."""
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--cache", nargs="?", const=True, default=None,
                   metavar="DIR",
                   help="persistent certificate cache: --cache DIR uses "
                        f"DIR, bare --cache uses {DEFAULT_CACHE_DIR}/ "
                        "(default: on only when $GRAPHGUARD_TORCH_CACHE_DIR "
                        "is set)")
    g.add_argument("--no-cache", action="store_true",
                   help="disable the certificate cache even if "
                        "$GRAPHGUARD_TORCH_CACHE_DIR is set")


def cache_from_args(args):
    """Map the flag pair onto :func:`repro_torch.runtime.resolve_cache`
    input."""
    if args.no_cache:
        return False
    return args.cache                    # None -> env default; True/DIR


def golden_mismatches(got: dict, golden: dict) -> Dict[str, list]:
    """Task ids missing from, extra to, or changed against a golden
    stable summary.  Everything compares exactly except R_o, which
    compares up to a renaming of ``t<N>`` names (fx and jaxpr number
    their tensors differently)."""
    def same(a: dict, b: dict) -> bool:
        if {k: v for k, v in a.items() if k != "r_o"} \
                != {k: v for k, v in b.items() if k != "r_o"}:
            return False
        if ("r_o" in a) != ("r_o" in b):
            return False
        return "r_o" not in a or same_up_to_renaming(a["r_o"], b["r_o"])
    return {
        "missing": sorted(set(golden) - set(got)),
        "extra": sorted(set(got) - set(golden)),
        "changed": sorted(k for k in set(got) & set(golden)
                          if not same(got[k], golden[k])),
    }


def main(argv=None) -> int:
    """CLI for ``python -m repro_torch.api``: run the suite matrix."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Run the verification suite matrix in parallel.")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="cases to run (default: every registered strategy)")
    ap.add_argument("--degrees", nargs="*", type=parse_degree, default=None,
                    help="parallelism degrees — ints like `2 4`, or "
                         "per-mesh-axis values like `4x2` for 2D cases "
                         "(default: per-case registry metadata)")
    ap.add_argument("--bugs", action="store_true",
                    help="also run every hosted bug variant")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where every task traces (default: cuda, which "
                         "must exist)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-task timeout in seconds")
    add_cache_flags(ap)
    ap.add_argument("--json", default=None, help="write full report JSON")
    ap.add_argument("--markdown", default=None, help="write Markdown table")
    ap.add_argument("--check", default=None, metavar="GOLDEN",
                    help="diff the stable summary against a golden JSON "
                         "(R_o up to renaming) and fail on mismatch")
    ap.add_argument("--write-golden", default=None, metavar="PATH",
                    help="write the stable summary as a golden to PATH")
    ap.add_argument("--update-golden", default=None, metavar="PATH",
                    help="regenerate the clean degree-2 matrix's golden "
                         "into PATH and exit (refuses a failing matrix, "
                         "the JAX package's tests/golden/suite_degree2.json"
                         " and the matrix flags)")
    args = ap.parse_args(argv)

    if args.update_golden is not None:
        clash = [flag for flag, v in (
            ("--cases", args.cases), ("--degrees", args.degrees),
            ("--bugs", args.bugs or None), ("--json", args.json),
            ("--markdown", args.markdown), ("--check", args.check),
            ("--cache", args.cache), ("--no-cache", args.no_cache or None),
            ("--write-golden", args.write_golden)) if v is not None]
        if clash:
            ap.error(f"--update-golden regenerates the clean degree-2 "
                     f"matrix and cannot be combined with "
                     f"{', '.join(clash)} (use --write-golden PATH for a "
                     f"custom matrix)")
        return update_golden(args.update_golden, workers=args.workers,
                             timeout_s=args.timeout, device=args.device)

    with Suite(cases=args.cases, degrees=args.degrees,
               include_bugs=args.bugs) as suite:
        result = suite.run(workers=args.workers, timeout_s=args.timeout,
                           cache=cache_from_args(args), device=args.device)
    print(result.to_markdown())
    if args.json:
        result.write(args.json)
        print(f"[suite] wrote {args.json}", file=sys.stderr)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(result.to_markdown() + "\n")
    if args.write_golden:
        with open(args.write_golden, "w") as f:
            json.dump(result.stable_summary(), f, indent=2, sort_keys=True)
        print(f"[suite] wrote golden {args.write_golden}", file=sys.stderr)
    rc = 0 if result.ok else 1
    if args.check:
        with open(args.check) as f:
            golden = json.load(f)
        got = result.stable_summary()
        diff = golden_mismatches(got, golden)
        if any(diff.values()):
            print(f"[suite] GOLDEN MISMATCH vs {args.check}: "
                  f"missing={diff['missing']} extra={diff['extra']} "
                  f"changed={diff['changed']}", file=sys.stderr)
            for k in diff["changed"]:
                print(f"  {k}:\n    golden: {golden[k]}\n    got:    {got[k]}",
                      file=sys.stderr)
            rc = 1
        else:
            print(f"[suite] matches golden {args.check} (R_o up to "
                  f"renaming)", file=sys.stderr)
    return rc

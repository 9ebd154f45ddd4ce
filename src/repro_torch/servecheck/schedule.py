"""Scheduler: fan unique serving obligations across the shared runtime.

``check_serve`` is the subsystem entry point.  Unique obligations (after
position-class dedup) are verified in-process or on a supervised spawn
pool (:mod:`repro_torch.runtime`) — workers receive only picklable
``(strategy, degree, bug, key, engine opts, device)`` tuples and rebuild
the obligation from the deterministic registry, so nothing unpicklable
crosses the boundary and reports stay byte-identical for any worker
count.  Every graph is traced with real tensors on one device (``cuda``
unless ``device="cpu"`` is asked for), in this process and in each worker
alike.  ``timeout_s`` budgets each obligation individually from the
moment it starts on a worker; ``cache=`` attaches the persistent
certificate cache keyed by :func:`repro_torch.runtime.serve_cache_key`
(strategy + obligation content digest), so a warm re-run replays every
serve verdict from disk.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, Optional, Tuple

from ..api.report import Report
from ..api.runner import _engine_opts, capture_task
from ..api.spec import Degree, task_id
from ..core import RefinementError, check_refinement
from ..core.explain import aggregate_explanations
from ..core.terms import pretty
from ..models.registry import resolve_device
from ..modelcheck.obligations import Obligation
from ..modelcheck.stitch import expected_output_relation
from ..obs import trace as obs_trace
from ..runtime import (RuntimeTask, pool_stats, resolve_cache, run_tasks,
                       serve_cache_key)
from .obligations import ServeStrategy, get_serve_strategy
from .report import ServeReport, StepResult

DEFAULT_TIMEOUT_S = 600.0


def _expected_for(ob: Obligation, entry: ServeStrategy) -> str:
    bug = dict(ob.structure).get("bug", "-")
    return "certificate" if bug == "-" else entry.bug_spec(bug).expected


def _verify_obligation(ob: Obligation, name: str, expected: str,
                       engine_opts: Optional[dict] = None,
                       device=None) -> dict:
    """Verify one serving obligation, traced on ``device``; returns a
    JSON-ready nested Report dict with the cache seam check (inferred R_o
    vs the relation the cache's PartitionSpec promises) attached — the
    seam is what catches the paper's silent-misplacement mode, where a
    wrong-axis collective still *refines* but assembles the cache
    off-spec."""
    bug = dict(ob.structure).get("bug", "-")
    bug = None if bug == "-" else bug
    spec = ob.to_strategy_spec(name=name, bug=bug, expected=expected)
    t0 = time.perf_counter()
    try:
        with _engine_opts(engine_opts) as eo:
            gs, gd, r_i = capture_task(spec, device)
            with obs_trace.span("infer", cat="engine", case=name):
                cert = check_refinement(gs, gd, r_i, max_nodes=eo.max_nodes,
                                        explain=eo.explain)
    except RefinementError as e:
        return Report(
            case=name, degree=spec.degree, bug=bug,
            verdict="refinement_error", expected=expected,
            ok=expected == "refinement_error", localization=e.payload(),
            explanation=getattr(e, "explanation", None),
            wall_s=round(time.perf_counter() - t0, 6)).to_json()
    except Exception as e:  # noqa: BLE001 — capture/engine failure -> verdict
        return Report(
            case=name, degree=spec.degree, bug=bug,
            verdict="error", expected=expected, ok=False,
            error=f"{type(e).__name__}: {e}",
            wall_s=round(time.perf_counter() - t0, 6)).to_json()

    # seam check: each distributed cache/read output must assemble exactly
    # as its PartitionSpec promises the next decode step's input relation
    n_ranks = 1
    for _, s in ob.mesh_axes:
        n_ranks *= s
    seams, seams_ok = [], True
    for j, (out_name, ospec) in enumerate(zip(gs.outputs, ob.out_specs)):
        gd_out = gd.outputs[j * n_ranks]
        base = gd_out.split("@")[0]
        expect = expected_output_relation(
            base, gd.shapes[gd_out], gd.dtypes[gd_out], ospec,
            dict(ob.mesh_axes))
        got = cert.r_o.get(out_name)
        ok = got is expect               # Terms are hash-consed: identity
        seams_ok &= ok
        seams.append({"output": out_name, "ok": ok,
                      "expected": pretty(expect, 999),
                      "got": None if got is None else pretty(got, 999)})
    cert_json = cert.to_json()
    ok = seams_ok if expected == "certificate" else \
        (expected == "unexpected_relation" and not seams_ok)
    d = Report(
        case=name, degree=spec.degree, bug=bug,
        verdict="certificate", expected=expected, ok=ok,
        r_o=cert_json["r_o"], stats=cert_json["stats"],
        explanation=cert.explanation,
        wall_s=round(time.perf_counter() - t0, 6)).to_json()
    d["seams"] = seams
    return d


def _pool_task(strategy: str, degree: Degree, bug: Optional[str],
               key: str, engine_opts: Optional[dict], device: str) -> dict:
    """Pool worker: rebuild the (deterministic) obligation set and verify
    the obligation addressed by ``key`` on ``device``."""
    entry = get_serve_strategy(strategy)
    ob = entry.build(degree=degree, bug=bug).unique[key]
    base = f"serve@{task_id(strategy, degree, bug)}"
    return _verify_obligation(ob, f"{base}:{key}",
                              _expected_for(ob, entry), engine_opts, device)


def _outcome_report(ob: Obligation, entry: ServeStrategy, name: str,
                    outcome) -> dict:
    """Convert a runtime outcome into this obligation's report dict."""
    if outcome.ok:
        d = dict(outcome.value)
        if outcome.cache == "hit":
            # cache entries are content-addressed — re-label for this run
            d["case"] = name
        info = outcome.runtime_info()
        if info:
            d["runtime"] = info
        return d
    verdict = "timeout" if outcome.status == "timeout" else "error"
    return Report(
        case=name, degree=tuple(s for _, s in ob.mesh_axes), bug=None,
        verdict=verdict, expected=_expected_for(ob, entry), ok=False,
        error=outcome.error, wall_s=round(outcome.wall_s, 6),
        runtime=outcome.runtime_info() or None).to_json()


def run_serve_obligations(strategy: str, degree: Degree,
                          bug: Optional[str] = None,
                          workers: Optional[int] = None,
                          engine_opts: Optional[dict] = None,
                          timeout_s: float = DEFAULT_TIMEOUT_S,
                          cache=None, device=None
                          ) -> Tuple[Dict[str, dict], int, Optional[dict],
                                     dict]:
    """Verify the strategy's unique serving obligations, traced on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for) in this process or
    in each worker.

    Returns ``({obligation key: report dict}, workers actually used,
    cache stats or None, runtime pool stats)``.  ``timeout_s`` budgets
    each obligation individually; ``cache`` takes anything
    :func:`repro_torch.runtime.resolve_cache` accepts.
    """
    device = str(resolve_device(device))
    entry = get_serve_strategy(strategy)
    obset = entry.build(degree=degree, bug=bug)
    keys = obset.keys_in_order()
    if workers is None:
        # dedup leaves a handful of obligations, most sub-second; fan out
        # only when there is genuinely parallel work
        workers = min(4, len(keys)) if len(keys) > 4 else 1
    cache = resolve_cache(cache)
    base = f"serve@{task_id(strategy, degree, bug)}"
    tasks = []
    for key in keys:
        ob = obset.unique[key]
        tasks.append(RuntimeTask(
            key=key, fn=_pool_task,
            args=(strategy, degree, bug, key, engine_opts, device),
            budget_s=timeout_s,
            cache_key=None if cache is None
            else serve_cache_key(strategy, key, engine_opts),
            local_fn=partial(_verify_obligation, ob, f"{base}:{key}",
                             _expected_for(ob, entry), engine_opts,
                             device)))
    used = min(workers, len(keys)) or 1
    # the pool always spawns its workers (see modelcheck.schedule)
    outcomes = run_tasks(tasks, used, cache=cache, device=device)
    reports = {key: _outcome_report(obset.unique[key], entry,
                                    f"{base}:{key}", outcomes[key])
               for key in keys}
    cache_stats = None if cache is None else {
        "dir": cache.dir,
        "hits": sum(1 for o in outcomes.values() if o.cache == "hit"),
        "misses": sum(1 for o in outcomes.values() if o.cache == "miss"),
        "entries": len(cache),
        "recovered_corrupt": cache.recovered_corrupt}
    return reports, used, cache_stats, pool_stats(outcomes)


def check_serve(strategy: str, *, degree: Optional[Degree] = None,
                bug: Optional[str] = None, workers: Optional[int] = None,
                engine_opts: Optional[dict] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                cache=None, device=None) -> ServeReport:
    """Serving-path refinement check: decode steps + prefill read, deduped
    by position class, verified, stitched.

    Every graph is traced on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for; without a GPU and without ``device=`` the call raises).
    Returns a :class:`ServeReport`; never raises on verification failures
    (they become step verdicts) — only on caller mistakes (unknown
    strategy / bug / degree, no device).  ``cache`` attaches the
    persistent certificate cache (see
    :func:`repro_torch.runtime.resolve_cache`).
    """
    t0 = time.perf_counter()
    device = str(resolve_device(device))
    entry = get_serve_strategy(strategy)
    if degree is None:
        degree = entry.degrees[0]
    degree = entry.validate_degree(degree)
    if bug is not None and bug not in entry.bug_names():
        raise ValueError(
            f"bug `{bug}` is not hosted by serve strategy `{strategy}` "
            f"(hosted: {sorted(entry.bug_names()) or '-'})")
    obset = entry.build(degree=degree, bug=bug)
    obs_trace.event("dedup", cat="engine", subsystem="servecheck",
                    total=obset.total_blocks, unique=obset.n_unique)
    reports, used, cache_stats, pstats = run_serve_obligations(
        strategy, degree, bug=bug, workers=workers,
        engine_opts=engine_opts, timeout_s=timeout_s, cache=cache,
        device=device)

    steps: List[StepResult] = []
    failing: List[str] = []
    seen: set = set()
    for name, key in obset.blocks:
        rep = reports[key]
        ob = obset.unique[key]
        seams = rep.get("seams") or []
        relation_ok = all(s["ok"] for s in seams) if seams else \
            rep["verdict"] == "certificate"
        loc = rep.get("localization") or {}
        steps.append(StepResult(
            step=name, pos_class=dict(ob.structure)["pos_class"],
            obligation=key, verdict=rep["verdict"],
            relation_ok=relation_ok, cached=key in seen,
            localized_op=loc.get("op_name")))
        seen.add(key)
        if rep["verdict"] != "certificate" or not relation_ok:
            failing.append(name)

    verdicts = {s.verdict for s in steps}
    if verdicts & {"error", "timeout"}:
        verdict = "error"
    elif "refinement_error" in verdicts:
        verdict = "refinement_error"
    elif any(not s.relation_ok for s in steps):
        verdict = "unexpected_relation"
    else:
        verdict = "certificate"

    bug_step = entry.bug_steps.get(bug) if bug else None
    if bug is None:
        ok = verdict == "certificate"
    else:
        # the injected serving bug must surface the way its BugSpec
        # declares (refinement_error raise, or unexpected_relation via
        # the cache seam) AND localize to exactly its decode step — the
        # position-class siblings of the bugged step must stay clean
        ok = (verdict == entry.bug_spec(bug).expected
              and failing == [f"step{bug_step}"])

    return ServeReport(
        strategy=strategy, degree=degree, verdict=verdict, ok=ok,
        steps=steps, reports=dict(reports),
        total_steps=obset.total_blocks,
        unique_obligations=obset.n_unique,
        dedup_ratio=round(obset.dedup_ratio, 3),
        failing_steps=failing, bug=bug, bug_step=bug_step,
        wall_s=round(time.perf_counter() - t0, 6), workers=used,
        cache=cache_stats, pool=pstats,
        explanation=aggregate_explanations(reports))

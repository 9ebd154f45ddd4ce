"""Scheduler: fan per-parameter gradient obligations across the runtime.

``check_train`` is the subsystem entry point.  Parameter obligations are
verified in-process or on a supervised spawn pool
(:mod:`repro_torch.runtime`) — workers receive only picklable
``(strategy, degree, bug, param, engine opts, device)`` tuples and
rebuild the obligation from the deterministic registry, so nothing
unpicklable crosses the boundary and certificates stay byte-identical
for any worker count.  Both graphs are traced in ``jax.grad``'s backward
form (``capture_grad.capture_train_task``) with real tensors on one device
(``cuda`` unless ``device="cpu"`` is asked for); ``replay_train`` replays
a certificate numerically from the same capture.  ``timeout_s`` budgets each
parameter obligation individually from the moment it starts on a worker;
``cache=`` attaches the persistent certificate cache keyed per
(strategy spec, parameter).
"""
from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, Optional, Tuple

from ..api.replay import replay_graphs
from ..api.report import Report
from ..api.runner import _engine_opts
from ..api.spec import Degree, StrategySpec, task_id
from ..core import RefinementError, check_refinement
from ..core.explain import aggregate_explanations
from ..core.terms import pretty
from ..models.registry import resolve_device
from ..obs import trace as obs_trace
from ..runtime import (RuntimeTask, pool_stats, resolve_cache, run_tasks,
                       strategy_cache_key)
from .capture_grad import capture_train_task
from .obligations import get_train_strategy
from .report import ParamResult, TrainReport
from .transpose import expected_grad_relation, grad_collective

DEFAULT_TIMEOUT_S = 600.0


def replay_train(spec: StrategySpec, device=None) -> tuple:
    """``api.replay.replay`` for one parameter's gradient obligation:
    ``(reconstructed, sequential)`` gradients from graphs traced in
    ``jax.grad``'s backward form on ``device``."""
    dev = resolve_device(device)
    return replay_graphs(spec, *capture_train_task(spec, dev), dev)


def _verify_param(spec: StrategySpec, param: str,
                  engine_opts: Optional[dict] = None, device=None) -> dict:
    """Verify one parameter's gradient obligation, traced on ``device``;
    returns a JSON-ready
    nested Report dict with the transposition seam (inferred R_o vs the
    relation the parameter's PartitionSpec transposes to) attached."""
    # by convention the loss-data (batch) input is the obligation's first
    # input — see register_train_strategy; its sharding determines which
    # axes the local backward partial-sums over.  A custom strategy whose
    # parameter is not an input degrades to an unknown collective rather
    # than crashing the scheduler.
    try:
        i = spec.input_names.index(param)
        collective, axes = grad_collective(spec.in_specs[i],
                                           spec.in_specs[0], spec.mesh_axes)
        coll = collective if not axes else f"{collective}({','.join(axes)})"
        param_spec = spec.in_specs[i]
    except ValueError:
        coll, param_spec = "?", None
    t0 = time.perf_counter()
    try:
        with _engine_opts(engine_opts) as eo:
            # seq_fn is already grad_of(loss, param) — the sequential
            # backward graph; the dist side traces the per-rank backward
            # + collectives
            gs, gd, r_i = capture_train_task(spec, device)
            with obs_trace.span("infer", cat="engine", case=spec.name):
                cert = check_refinement(gs, gd, r_i,
                                        max_nodes=eo.max_nodes,
                                        explain=eo.explain)
    except RefinementError as e:
        d = Report(
            case=spec.name, degree=spec.degree, bug=spec.bug,
            verdict="refinement_error", expected=spec.expected,
            ok=spec.expected == "refinement_error", localization=e.payload(),
            explanation=getattr(e, "explanation", None),
            wall_s=round(time.perf_counter() - t0, 6)).to_json()
        d["collective"] = coll
        return d
    except Exception as e:  # noqa: BLE001 — capture/engine failure -> verdict
        d = Report(
            case=spec.name, degree=spec.degree, bug=spec.bug,
            verdict="error", expected=spec.expected, ok=False,
            error=f"{type(e).__name__}: {e}",
            wall_s=round(time.perf_counter() - t0, 6)).to_json()
        d["collective"] = coll
        return d

    # transposition seam: the inferred gradient relation must equal the
    # one the parameter's PartitionSpec transposes to (skipped when the
    # parameter is not an input — no spec to transpose)
    if param_spec is not None:
        gd_out = gd.outputs[0]
        expect = expected_grad_relation(
            gd_out.split("@")[0], gd.shapes[gd_out], gd.dtypes[gd_out],
            param_spec, spec.mesh_axes)
        got = next(iter(cert.r_o.values()), None)
        relation_ok = got is expect      # Terms are hash-consed: identity
    else:
        expect, got, relation_ok = None, None, True
    cert_json = cert.to_json()
    d = Report(
        case=spec.name, degree=spec.degree, bug=spec.bug,
        verdict="certificate", expected=spec.expected,
        ok=spec.expected == "certificate" and relation_ok,
        r_o=cert_json["r_o"], stats=cert_json["stats"],
        explanation=cert.explanation,
        wall_s=round(time.perf_counter() - t0, 6)).to_json()
    d["collective"] = coll
    d["relation"] = {
        "ok": relation_ok,
        "expected": None if expect is None else pretty(expect, 999),
        "got": None if got is None else pretty(got, 999)}
    return d


def _pool_task(strategy: str, degree: Degree, bug: Optional[str],
               param: str, engine_opts: Optional[dict], device: str) -> dict:
    """Pool worker: rebuild the obligation by name and verify it on
    ``device``."""
    spec = get_train_strategy(strategy).build(degree=degree, bug=bug)[param]
    return _verify_param(spec, param, engine_opts, device)


def _outcome_report(spec: StrategySpec, outcome) -> dict:
    """Convert a runtime outcome into this parameter's report dict."""
    if outcome.ok:
        d = dict(outcome.value)
        info = outcome.runtime_info()
        if info:
            d["runtime"] = info
        return d
    verdict = "timeout" if outcome.status == "timeout" else "error"
    d = Report(
        case=spec.name, degree=spec.degree, bug=spec.bug,
        verdict=verdict, expected=spec.expected, ok=False,
        error=outcome.error, wall_s=round(outcome.wall_s, 6),
        runtime=outcome.runtime_info() or None).to_json()
    d["collective"] = "?"
    return d


def run_train_obligations(strategy: str, degree: Degree,
                          bug: Optional[str] = None,
                          workers: Optional[int] = None,
                          engine_opts: Optional[dict] = None,
                          timeout_s: float = DEFAULT_TIMEOUT_S,
                          cache=None, device=None
                          ) -> Tuple[Dict[str, dict], int, Optional[dict],
                                     dict]:
    """Verify every parameter obligation, traced on ``device`` (``cuda``
    unless ``"cpu"`` is asked for) in this process or in each worker.

    Returns ``({param: report dict}, workers actually used, cache stats
    or None, runtime pool stats)``.  ``timeout_s`` budgets each parameter
    obligation individually; ``cache`` takes anything
    :func:`repro_torch.runtime.resolve_cache` accepts.
    """
    device = str(resolve_device(device))
    entry = get_train_strategy(strategy)
    specs = entry.build(degree=degree, bug=bug)
    params = list(specs)
    if workers is None:
        # sub-second obligations, small count: in-process beats pool spin-up
        workers = min(4, len(params)) if len(params) > 4 else 1
    cache = resolve_cache(cache)
    base = f"train@{task_id(strategy, degree, bug)}"
    tasks = []
    for param in params:
        spec = specs[param]
        # the per-parameter specs share name/mesh/inputs (they differ in
        # the traced grad fn, which is not hashable) — the parameter name
        # must be part of the cache identity
        cache_key = None if cache is None else \
            f"{strategy_cache_key(spec, engine_opts)}:grad-{param}"
        tasks.append(RuntimeTask(
            key=f"{base}:{param}", fn=_pool_task,
            args=(strategy, degree, bug, param, engine_opts, device),
            budget_s=timeout_s, cache_key=cache_key,
            local_fn=partial(_verify_param, spec, param, engine_opts,
                             device)))
    used = min(workers, len(params)) or 1
    # the pool always spawns (see modelcheck.schedule)
    outcomes = run_tasks(tasks, used, cache=cache, device=device)
    reports = {param: _outcome_report(specs[param],
                                      outcomes[f"{base}:{param}"])
               for param in params}
    cache_stats = None if cache is None else {
        "dir": cache.dir,
        "hits": sum(1 for o in outcomes.values() if o.cache == "hit"),
        "misses": sum(1 for o in outcomes.values() if o.cache == "miss"),
        "entries": len(cache),
        "recovered_corrupt": cache.recovered_corrupt}
    return reports, used, cache_stats, pool_stats(outcomes)


def check_train(strategy: str, *, degree: Optional[Degree] = None,
                bug: Optional[str] = None, workers: Optional[int] = None,
                engine_opts: Optional[dict] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                cache=None, device=None) -> TrainReport:
    """Train-step refinement check: one obligation per parameter, stitched.

    Every graph is traced on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for; without a GPU and without ``device=`` the call raises).
    Returns a :class:`TrainReport`; never raises on verification failures
    (they become parameter verdicts) — only on caller mistakes (unknown
    strategy / bug / degree, no device).  ``cache`` attaches the
    persistent certificate cache (see
    :func:`repro_torch.runtime.resolve_cache`).
    """
    t0 = time.perf_counter()
    device = str(resolve_device(device))
    entry = get_train_strategy(strategy)
    if degree is None:
        degree = entry.degrees[0]
    degree = entry.validate_degree(degree)
    if bug is not None and bug not in entry.bug_names():
        raise ValueError(
            f"bug `{bug}` is not hosted by train strategy `{strategy}` "
            f"(hosted: {sorted(entry.bug_names()) or '-'})")
    reports, used, cache_stats, pstats = run_train_obligations(
        strategy, degree, bug=bug, workers=workers,
        engine_opts=engine_opts, timeout_s=timeout_s, cache=cache,
        device=device)

    params: List[ParamResult] = []
    failing: List[str] = []
    for param in entry.params:
        rep = reports[param]
        rel = rep.get("relation") or {}
        relation_ok = bool(rel.get("ok")) if rel else \
            rep["verdict"] == "certificate"
        loc = rep.get("localization") or {}
        params.append(ParamResult(
            param=param, verdict=rep["verdict"], relation_ok=relation_ok,
            collective=rep.get("collective", "?"),
            localized_op=loc.get("op_name")))
        if rep["verdict"] != "certificate" or not relation_ok:
            failing.append(param)

    verdicts = {p.verdict for p in params}
    if verdicts & {"error", "timeout"}:
        verdict = "error"
    elif "refinement_error" in verdicts:
        verdict = "refinement_error"
    elif any(not p.relation_ok for p in params):
        verdict = "unexpected_relation"
    else:
        verdict = "certificate"

    bug_param = entry.bug_params.get(bug) if bug else None
    if bug is None:
        ok = verdict == "certificate"
    else:
        # the injected gradient bug must surface the way its BugSpec
        # declares (refinement_error raise, or unexpected_relation via
        # the transposition seam) AND localize to exactly its parameter
        ok = (verdict == entry.bug_spec(bug).expected
              and failing == [bug_param])

    return TrainReport(
        strategy=strategy, degree=degree, verdict=verdict, ok=ok,
        params=params, reports=dict(reports), failing_params=failing,
        bug=bug, bug_param=bug_param,
        wall_s=round(time.perf_counter() - t0, 6), workers=used,
        cache=cache_stats, pool=pstats,
        explanation=aggregate_explanations(reports))

"""Scheduler: fan unique obligations across the shared runtime.

``check_model`` is the subsystem entry point.  Unique obligations (after
dedup) are verified in-process or on a supervised spawn pool
(:mod:`repro_torch.runtime`) — workers receive only picklable
``(model id, plan name, bug, bug_layer, key, engine opts, device)``
tuples and rebuild the obligation from the deterministic decomposition,
so nothing unpicklable crosses the boundary and certificates stay
byte-identical for any worker count.  Every graph is traced with real
tensors on one device (``cuda`` unless ``device="cpu"`` is asked for),
in this process and in each worker alike.  ``timeout_s`` is a
*per-obligation* budget enforced from the moment the obligation starts
on a worker, so one slow obligation can never eat the budget of those
queued behind it — the offender alone is reported as ``timeout`` with
its measured elapsed time.  With a
persistent cache attached (``cache=``), committed obligations are served
across runs by ``obligations.canonical_key`` content addressing.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Dict, Optional, Tuple, Union

from ..api.report import Report
from ..api.runner import _engine_opts, capture_task
from ..core import RefinementError, check_refinement
from ..core.terms import pretty
from ..models.config import ModelConfig
from ..models.registry import load_config, resolve_device
from ..obs import trace as obs_trace
from ..runtime import (RuntimeTask, obligation_cache_key, pool_stats,
                       resolve_cache, run_tasks)
from ..sharding.specs import MeshPlan
from .decompose import Decomposition, decompose, list_model_ids
from .obligations import Obligation
from .report import ModelReport
from .stitch import expected_output_relation, stitch

DEFAULT_TIMEOUT_S = 600.0


def _expected_for(ob: Obligation) -> str:
    return ("refinement_error"
            if dict(ob.structure).get("bug", "-") != "-" else "certificate")


def _verify_obligation(ob: Obligation, name: str, expected: str,
                       engine_opts: Optional[dict] = None,
                       device=None) -> dict:
    """Verify one obligation, traced on ``device``; returns a JSON-ready
    nested Report dict with the seam check (inferred R_o vs spec-promised
    relation) attached."""
    spec = ob.to_strategy_spec(
        name=name, expected=expected,
        bug=None if expected == "certificate" else "wrong_spec")
    t0 = time.perf_counter()
    try:
        with _engine_opts(engine_opts) as eo:
            gs, gd, r_i = capture_task(spec, device)
            with obs_trace.span("infer", cat="engine", case=name):
                cert = check_refinement(gs, gd, r_i, max_nodes=eo.max_nodes,
                                        explain=eo.explain)
    except RefinementError as e:
        return Report(
            case=name, degree=spec.degree, bug=spec.bug,
            verdict="refinement_error", expected=expected,
            ok=expected == "refinement_error", localization=e.payload(),
            explanation=getattr(e, "explanation", None),
            wall_s=round(time.perf_counter() - t0, 6)).to_json()
    except Exception as e:  # noqa: BLE001 — capture/engine failure -> verdict
        return Report(
            case=name, degree=spec.degree, bug=spec.bug,
            verdict="error", expected=expected, ok=False,
            error=f"{type(e).__name__}: {e}",
            wall_s=round(time.perf_counter() - t0, 6)).to_json()

    # seam check: each distributed output must assemble exactly as its
    # output PartitionSpec promises the next block's input relation
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
    d = Report(
        case=name, degree=spec.degree, bug=spec.bug,
        verdict="certificate", expected=expected,
        ok=expected == "certificate" and seams_ok,
        r_o=cert_json["r_o"], stats=cert_json["stats"],
        explanation=cert.explanation,
        wall_s=round(time.perf_counter() - t0, 6)).to_json()
    d["seams"] = seams
    return d


def _task_name(dec: Decomposition, key: str) -> str:
    return f"{dec.model}:{dec.plan.name}:{key}"


def _pool_task(model: str, plan: str, bug: Optional[str],
               bug_layer: Optional[int], key: str,
               engine_opts: Optional[dict], device: str) -> dict:
    """Pool worker: rebuild the (deterministic) decomposition on
    ``device`` and verify the obligation addressed by ``key``."""
    dec = decompose(model, plan, bug=bug, bug_layer=bug_layer,
                    device=device)
    ob = dec.obset.unique[key]
    return _verify_obligation(ob, _task_name(dec, key),
                              _expected_for(ob), engine_opts, device)


def _poolable(dec: Decomposition) -> bool:
    """Workers rebuild by model id — only stock configs round-trip."""
    return (dec.model in list_model_ids()
            and load_config(dec.model) == dec.cfg)


def _outcome_report(dec: Decomposition, key: str, outcome) -> dict:
    """Convert a runtime outcome into this obligation's report dict."""
    if outcome.ok:
        d = dict(outcome.value)
        if outcome.cache == "hit":
            # cache entries are content-addressed — the committed report
            # may carry the task name of another model that shares the
            # obligation; re-label it for this decomposition
            d["case"] = _task_name(dec, key)
        info = outcome.runtime_info()
        if info:
            d["runtime"] = info
        return d
    ob = dec.obset.unique[key]
    verdict = "timeout" if outcome.status == "timeout" else "error"
    return Report(
        case=_task_name(dec, key),
        degree=tuple(s for _, s in ob.mesh_axes), bug=None,
        verdict=verdict, expected=_expected_for(ob), ok=False,
        error=outcome.error, wall_s=round(outcome.wall_s, 6),
        runtime=outcome.runtime_info() or None).to_json()


def run_obligations(dec: Decomposition, workers: Optional[int] = None,
                    engine_opts: Optional[dict] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S,
                    cache=None
                    ) -> Tuple[Dict[str, dict], int, Optional[dict], dict]:
    """Verify the decomposition's unique obligations.

    Returns ``({key: report dict}, workers actually used, cache stats or
    None, runtime pool stats)``.  ``timeout_s`` budgets each obligation
    individually — the runtime starts the clock when the obligation
    starts on a worker, so a slow obligation times out alone instead of
    marking everything queued behind it.  ``cache`` takes anything
    :func:`repro_torch.runtime.resolve_cache` accepts.  Workers trace on
    the decomposition's device.
    """
    keys = dec.obset.keys_in_order()
    if workers is None:
        # auto: dedup usually leaves a single model with 3-4 sub-second
        # obligations — in-process beats paying pool spin-up; fan out only
        # when there is genuinely parallel work
        workers = min(4, len(keys)) if len(keys) > 4 else 1
    if workers >= 2 and not _poolable(dec):
        workers = 1
    cache = resolve_cache(cache)
    tasks = []
    for key in keys:
        ob = dec.obset.unique[key]
        tasks.append(RuntimeTask(
            key=key, fn=_pool_task,
            args=(dec.model, dec.plan.name, dec.bug, dec.bug_layer, key,
                  engine_opts, dec.device),
            budget_s=timeout_s,
            cache_key=None if cache is None
            else obligation_cache_key(key, engine_opts),
            local_fn=partial(_verify_obligation, ob, _task_name(dec, key),
                             _expected_for(ob), engine_opts, dec.device)))
    used = min(workers, len(keys)) or 1
    # the pool always spawns its workers (a forked child cannot use the
    # parent's CUDA context); each worker reaches the device before its
    # first obligation
    outcomes = run_tasks(tasks, used, cache=cache, device=dec.device)
    reports = {key: _outcome_report(dec, key, outcomes[key])
               for key in keys}
    cache_stats = None if cache is None else {
        "dir": cache.dir,
        "hits": sum(1 for o in outcomes.values() if o.cache == "hit"),
        "misses": sum(1 for o in outcomes.values() if o.cache == "miss"),
        "entries": len(cache),
        "recovered_corrupt": cache.recovered_corrupt}
    return reports, used, cache_stats, pool_stats(outcomes)


def check_model(model: Union[str, ModelConfig], plan: Union[str, MeshPlan],
                *, bug: Optional[str] = None,
                bug_layer: Optional[int] = None,
                workers: Optional[int] = None,
                engine_opts: Optional[dict] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                cache=None, device=None) -> ModelReport:
    """Whole-model refinement check: decompose, dedup, verify, stitch.

    Every graph is traced on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for; without a GPU and without ``device=`` the call raises).
    Returns a :class:`ModelReport`; never raises on verification failures
    (they become block verdicts) — only on caller mistakes (unknown model /
    plan / bug, no device).  ``cache`` attaches the persistent certificate
    cache (see :func:`repro_torch.runtime.resolve_cache`), so a re-check
    after a one-block edit re-proves only the changed obligation.
    """
    t0 = time.perf_counter()
    device = str(resolve_device(device))
    dec = decompose(model, plan, bug=bug, bug_layer=bug_layer,
                    device=device)
    obs_trace.event("dedup", cat="engine", subsystem="modelcheck",
                    total=dec.total_blocks, unique=dec.n_unique)
    reports, used, cache_stats, pstats = run_obligations(
        dec, workers=workers, engine_opts=engine_opts,
        timeout_s=timeout_s, cache=cache)
    return stitch(dec, reports, time.perf_counter() - t0, used,
                  cache_stats=cache_stats, pool=pstats)

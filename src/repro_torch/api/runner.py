"""``verify()`` — the library entry point for one verification task.

    from repro_torch.api import verify
    report = verify("tp_layer", degree=4)            # -> Report, on cuda
    report = verify("sp_rope", bug="rope_offset", device="cpu")

Accepts a registered case name or an already-built ``StrategySpec`` (built
on the same device). The graphs are traced with real tensors on ``device``,
which is ``cuda`` unless ``"cpu"`` is asked for; without a GPU and without
``device=`` the call raises rather than running on the CPU. ``engine_opts``
tunes the engine per call without touching process-global state
afterwards:

    max_nodes       e-graph node budget (default 400_000)
    optimizations   None (leave the process setting), bool (all flags), or
                    a {flag: bool} dict of ``repro_torch.core.profile``
                    ``OptConfig`` overrides — restored after the call
    explain         record proof provenance (lemma chains / failure
                    frontiers, see ``repro_torch.core.explain``); None
                    defers to the ``GRAPHGUARD_EXPLAIN`` environment default

``run_spec()`` is the raising flavour (returns the live ``Certificate`` or
raises ``RefinementError``/``CaptureError``); ``verify()`` wraps it into a
structured :class:`~repro_torch.api.Report`.
"""
from __future__ import annotations

import time
from typing import Optional, Union

from ..core import (Certificate, RefinementError, capture, capture_spmd,
                    check_refinement, expand_spmd)
from ..core.profile import CONFIG, set_optimizations
from ..models.registry import resolve_device
from ..obs import trace as obs_trace
from .registry import build_spec
from .report import Report
from .spec import StrategySpec

DEFAULT_MAX_NODES = 400_000


def _resolve(spec_or_name: Union[str, StrategySpec], degree: Optional[int],
             bug: Optional[str], device) -> StrategySpec:
    if isinstance(spec_or_name, StrategySpec):
        if degree is not None or bug is not None:
            raise ValueError(
                "degree=/bug= only apply when verifying by name; this "
                "StrategySpec is already built for "
                f"degree={spec_or_name.degree}, bug={spec_or_name.bug!r} — "
                "use dataclasses.replace / build_spec to change it")
        return spec_or_name
    return build_spec(spec_or_name, degree=2 if degree is None else degree,
                      bug=bug, device=device)


class _engine_opts:
    """Apply {max_nodes, optimizations} for the duration of one call."""

    def __init__(self, opts: Optional[dict]):
        opts = dict(opts or {})
        self.max_nodes = opts.pop("max_nodes", DEFAULT_MAX_NODES)
        self.optimizations = opts.pop("optimizations", None)
        self.explain = opts.pop("explain", None)
        if opts:
            raise ValueError(f"unknown engine_opts: {sorted(opts)}")
        if isinstance(self.optimizations, dict):
            unknown = set(self.optimizations) - set(CONFIG.as_dict())
            if unknown:
                raise ValueError(
                    f"unknown optimization flags: {sorted(unknown)} "
                    f"(valid: {sorted(CONFIG.as_dict())})")
        self._saved = None

    def __enter__(self):
        if self.optimizations is not None:
            self._saved = CONFIG.as_dict()
            if isinstance(self.optimizations, dict):
                set_optimizations(True, **{**self._saved,
                                           **self.optimizations})
            else:
                set_optimizations(bool(self.optimizations))
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            set_optimizations(True, **self._saved)
        return False


def capture_task(spec: StrategySpec, device=None) -> tuple:
    """G_s, the expanded G_d and R_i of one task, traced on ``device``."""
    dev = resolve_device(device)
    with obs_trace.span("capture", cat="capture", graph="gs",
                        case=spec.name):
        gs = capture(spec.seq_fn, list(spec.avals), list(spec.input_names),
                     device=dev)
    with obs_trace.span("capture", cat="capture", graph="gd",
                        case=spec.name):
        cap = capture_spmd(spec.dist_fn, spec.mesh_axes,
                           list(spec.in_specs), list(spec.avals),
                           list(spec.input_names), device=dev)
        gd, r_i = expand_spmd(cap)
    return gs, gd, r_i


def run_spec(spec: StrategySpec, *, engine_opts: Optional[dict] = None,
             device=None) -> Certificate:
    """Capture G_s/G_d on ``device``, derive R_i, and run relation inference
    (raising)."""
    if not isinstance(engine_opts, _engine_opts):
        engine_opts = _engine_opts(engine_opts)
    with engine_opts as eo:
        gs, gd, r_i = capture_task(spec, device)
        with obs_trace.span("infer", cat="engine", case=spec.name):
            return check_refinement(gs, gd, r_i, max_nodes=eo.max_nodes,
                                    explain=eo.explain)


def verify(spec_or_name: Union[str, StrategySpec], *,
           degree: Optional[int] = None, bug: Optional[str] = None,
           engine_opts: Optional[dict] = None, device=None) -> Report:
    """Verify one task on ``device`` and return a structured
    :class:`Report`.

    ``degree`` (default 2) and ``bug`` select the task when verifying by
    name; passing them alongside an already-built ``StrategySpec`` raises
    rather than silently ignoring them.  Unknown case/bug names, the
    bug-under-wrong-case guard and a missing GPU also raise
    (``KeyError``/``ValueError``/``RuntimeError``): those are caller
    mistakes, not verification outcomes.  Capture and engine failures
    become the ``error`` verdict, with the exception in ``Report.error``.
    """
    device = resolve_device(device)
    spec = _resolve(spec_or_name, degree, bug, device)
    engine_opts = _engine_opts(engine_opts)   # caller mistakes raise here
    t0 = time.perf_counter()
    try:
        cert = run_spec(spec, engine_opts=engine_opts, device=device)
    except RefinementError as e:
        verdict, payload = "refinement_error", e.payload()
        return Report(
            case=spec.name, degree=spec.degree, bug=spec.bug,
            verdict=verdict, expected=spec.expected,
            ok=spec.expected_verdict == verdict, localization=payload,
            explanation=getattr(e, "explanation", None),
            wall_s=round(time.perf_counter() - t0, 6))
    except Exception as e:  # noqa: BLE001 — CaptureError/engine -> verdict
        return Report(
            case=spec.name, degree=spec.degree, bug=spec.bug,
            verdict="error", expected=spec.expected, ok=False,
            error=f"{type(e).__name__}: {e}",
            wall_s=round(time.perf_counter() - t0, 6))
    cert_json = cert.to_json()
    return Report(
        case=spec.name, degree=spec.degree, bug=spec.bug,
        verdict="certificate", expected=spec.expected,
        ok=spec.expected_verdict == "certificate",
        r_o=cert_json["r_o"], stats=cert_json["stats"], certificate=cert,
        explanation=cert.explanation,
        wall_s=round(time.perf_counter() - t0, 6))

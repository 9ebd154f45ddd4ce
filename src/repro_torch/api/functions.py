"""``verify_functions()`` — bring-your-own-function verification.

Hand the library the sequential function you trust, the distributed
(per-rank, written on ``repro_torch.core.spmd``'s collectives)
implementation you wrote, the mesh and the input ``PartitionSpec``\\ s, and
get back the standard :class:`~repro_torch.api.Report`::

    from repro_torch.api import verify_functions
    from repro_torch.core.spmd import PartitionSpec as P

    report = verify_functions(seq_mlp, dist_mlp, {"tp": 2},
                              in_specs=(P(), P(None, "tp"), P("tp", None)),
                              example_args=(x, w1, w2))
    assert report.verdict == "certificate"

Input shapes come from ``example_args`` (tensors, used only for their
shape/dtype) or ``avals`` (``TensorSpec`` or ``(shape, dtype)`` per
input); input names default to the sequential function's parameter names.
Both functions are traced on ``device`` (``cuda`` unless ``"cpu"`` is
asked for) through the strict :mod:`repro_torch.core.from_fx` frontend, so
an op the term language cannot model raises
:class:`~repro_torch.core.UnsupportedPrimitive` with the offending op and
the user's ``file:line`` — surfaced as an ``error`` verdict by
``verify_functions`` and as an exception by the raising flavour
``run_functions``.

The registered case suite doubles as the cross-check for this path:
capturing each case's functions here yields byte-identical certificates
to ``run_spec`` on the registered spec.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from ..core import (Certificate, RefinementError, capture_function,
                    capture_spmd_function, check_refinement, expand_spmd,
                    normalize_mesh)
from ..core.from_fx import default_input_names
from ..models.registry import resolve_device
from .report import Report
from .runner import _engine_opts
from .spec import StrategySpec, TensorSpec

__all__ = ["function_spec", "run_functions", "verify_functions"]


def _resolve_avals(avals, example_args) -> tuple:
    if (avals is None) == (example_args is None):
        raise ValueError(
            "pass exactly one of avals= (TensorSpecs) or example_args= "
            "(tensors, used for shape/dtype only)")
    if avals is not None:
        return tuple(TensorSpec(tuple(s), d) for s, d in avals)
    return tuple(TensorSpec(tuple(a.shape), a.dtype) for a in example_args)


def function_spec(fn_seq: Callable, fn_dist: Callable, mesh,
                  in_specs: Sequence, avals: Optional[Sequence] = None,
                  input_names: Optional[Sequence[str]] = None, *,
                  example_args: Optional[Sequence] = None,
                  name: Optional[str] = None) -> StrategySpec:
    """Build a :class:`StrategySpec` for an ad-hoc function pair.

    The returned spec carries the same fields a registered builder would
    produce; ``name`` defaults to the distributed function's ``__name__``
    and ``degree`` to the per-axis mesh sizes.
    """
    mesh_axes = normalize_mesh(mesh)
    avals = _resolve_avals(avals, example_args)
    if len(in_specs) != len(avals):
        raise ValueError(f"{len(in_specs)} in_specs for {len(avals)} inputs")
    if input_names is None:
        input_names = default_input_names(fn_seq, len(avals))
    degrees = tuple(mesh_axes.values())
    return StrategySpec(
        fn_seq, fn_dist, mesh_axes, tuple(in_specs), avals,
        tuple(input_names),
        name=name or getattr(fn_dist, "__name__", "user_fn"),
        degree=degrees if len(degrees) > 1 else degrees[0])


def run_functions(fn_seq: Callable, fn_dist: Callable, mesh,
                  in_specs: Sequence, avals: Optional[Sequence] = None,
                  input_names: Optional[Sequence[str]] = None, *,
                  example_args: Optional[Sequence] = None,
                  engine_opts: Optional[dict] = None,
                  device=None) -> Certificate:
    """Raising flavour of :func:`verify_functions` -> live ``Certificate``.

    Captures both functions on ``device`` through the strict generic
    frontend, expands the SPMD side per rank, derives the input
    relation from ``in_specs``, and runs relation inference.  Raises
    ``RefinementError`` when the implementation does not refine the
    sequential function and ``UnsupportedPrimitive`` when a function
    cannot be lowered.
    """
    dev = resolve_device(device)
    spec = function_spec(fn_seq, fn_dist, mesh, in_specs, avals, input_names,
                         example_args=example_args)
    if not isinstance(engine_opts, _engine_opts):
        engine_opts = _engine_opts(engine_opts)
    with engine_opts as eo:
        gs = capture_function(spec.seq_fn, list(spec.avals),
                              list(spec.input_names), device=dev)
        cap = capture_spmd_function(spec.dist_fn, spec.mesh_axes,
                                    list(spec.in_specs), list(spec.avals),
                                    list(spec.input_names), device=dev)
        gd, r_i = expand_spmd(cap)
        return check_refinement(gs, gd, r_i, max_nodes=eo.max_nodes,
                                explain=eo.explain)


def verify_functions(fn_seq: Callable, fn_dist: Callable, mesh,
                     in_specs: Sequence, avals: Optional[Sequence] = None,
                     input_names: Optional[Sequence[str]] = None, *,
                     example_args: Optional[Sequence] = None,
                     name: Optional[str] = None,
                     engine_opts: Optional[dict] = None,
                     device=None) -> Report:
    """Verify that ``fn_dist`` on ``mesh`` refines ``fn_seq`` -> ``Report``.

    The generic counterpart of :func:`~repro_torch.api.verify`: instead of
    a registered case name it takes the two functions directly.  Outcomes
    map to the standard verdicts — ``certificate`` (with the clean R_o
    relation), ``refinement_error`` (with the localized operator payload),
    or ``error`` (capture/engine failure, including
    ``UnsupportedPrimitive`` naming the user's ``file:line``).  Caller
    mistakes (mismatched avals/in_specs, bad mesh, bad engine_opts, no
    card without ``device=``) raise instead of becoming verdicts.
    """
    dev = resolve_device(device)
    spec = function_spec(fn_seq, fn_dist, mesh, in_specs, avals, input_names,
                         example_args=example_args, name=name)
    engine_opts = _engine_opts(engine_opts)   # caller mistakes raise here
    t0 = time.perf_counter()
    try:
        cert = run_functions(spec.seq_fn, spec.dist_fn, spec.mesh_axes,
                             spec.in_specs, spec.avals, spec.input_names,
                             engine_opts=engine_opts, device=dev)
    except RefinementError as e:
        return Report(
            case=spec.name, degree=spec.degree, bug=None,
            verdict="refinement_error", expected="certificate", ok=False,
            localization=e.payload(),
            explanation=getattr(e, "explanation", None),
            wall_s=round(time.perf_counter() - t0, 6))
    except Exception as e:  # noqa: BLE001 — capture/engine failure -> verdict
        return Report(
            case=spec.name, degree=spec.degree, bug=None,
            verdict="error", expected="certificate", ok=False,
            error=f"{type(e).__name__}: {e}",
            wall_s=round(time.perf_counter() - t0, 6))
    cert_json = cert.to_json()
    return Report(
        case=spec.name, degree=spec.degree, bug=None,
        verdict="certificate", expected="certificate", ok=True,
        r_o=cert_json["r_o"], stats=cert_json["stats"], certificate=cert,
        explanation=cert.explanation,
        wall_s=round(time.perf_counter() - t0, 6))

"""GraphGuard core on torch: static verification of distributed refinement.

Public API:
    capture, capture_spmd, expand_spmd   — graph capture (make_fx -> Graph)
    spmd                                 — the SPMD shim cases are written
                                           against (PartitionSpec,
                                           shard_map, collectives)
    strict_capture, UnsupportedPrimitive — strict capture frontend
    capture_function,                    — trace arbitrary function pairs
    capture_spmd_function,                 (always strict)
    normalize_mesh
    check_refinement, GraphGuard         — iterative relation inference
    Certificate, RefinementError         — results
    register_lemma                       — user lemma extension point
"""
from . import spmd, terms
from .capture import (Graph, CaptureError, SpmdCapture, capture,
                      capture_spmd, expand_spmd, derive_input_relation)
from .from_fx import (SUPPORTED_PRIMITIVES, UnsupportedPrimitive,
                      capture_function, capture_spmd_function,
                      normalize_mesh, strict_capture)
from .egraph import EGraph, Lemma, EGraphLimit, EGraphShapeError
from .infer import Certificate, GraphGuard, RefinementError, check_refinement
from .lemmas import all_lemmas, register_lemma
from .profile import CONFIG, OptConfig, Profile, set_optimizations
from .symbolic import AffExpr, ScalarSolver, NonAffine

__all__ = [
    "Graph", "CaptureError", "SpmdCapture", "capture", "capture_spmd",
    "expand_spmd", "derive_input_relation", "spmd", "SUPPORTED_PRIMITIVES",
    "UnsupportedPrimitive", "strict_capture", "capture_function",
    "capture_spmd_function", "normalize_mesh", "EGraph", "Lemma",
    "EGraphLimit", "EGraphShapeError", "Certificate", "GraphGuard",
    "RefinementError", "check_refinement", "all_lemmas", "register_lemma",
    "AffExpr", "ScalarSolver", "NonAffine", "terms", "CONFIG", "OptConfig",
    "Profile", "set_optimizations",
]

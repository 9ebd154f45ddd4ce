"""repro_torch.api — the verification API on torch.

Typed task model + pluggable strategy registry on top of the GraphGuard
engine (``repro_torch.core``):

    from repro_torch.api import verify, register_strategy

    report = verify("tp_layer", degree=2)          # structured Report, cuda
    report = verify("tp_layer", device="cpu")      # on the CPU

    result = Suite(degrees=(2,)).run(workers=4)     # the matrix, pooled
    report = verify_functions(seq_fn, dist_fn, {"tp": 2}, in_specs,
                              avals=avals)          # your own functions

Importing this package populates the registry with the case suite from
``repro_torch.dist.strategies``; third-party code registers new cases with
``@register_strategy`` without touching core.  ``python -m repro_torch.api``
runs the suite matrix from the command line.
"""
from .spec import (BugSpec, Degree, StrategySpec, EXPECTATIONS, TensorSpec,
                   axis_degrees, degree_token, normalize_degree, parse_degree,
                   task_id)
from .registry import (DuplicateStrategyError, RegisteredStrategy, bug_host,
                       build_spec, check_model_task, check_serve_task,
                       check_train_task, get_strategy, list_bugs,
                       list_model_tasks, list_serve_tasks, list_strategies,
                       list_train_tasks, register_strategy)
from .report import Report, VERDICTS
from .runner import capture_task, run_spec, verify
from .functions import function_spec, run_functions, verify_functions
from .suite import Suite, SuiteResult, SuiteTask

from ..dist import strategies as _strategies  # noqa: F401 — populate registry

__all__ = [
    "BugSpec", "Degree", "StrategySpec", "EXPECTATIONS", "TensorSpec",
    "axis_degrees", "degree_token", "normalize_degree", "parse_degree",
    "task_id", "DuplicateStrategyError", "RegisteredStrategy", "bug_host",
    "build_spec", "check_model_task", "check_serve_task", "check_train_task",
    "get_strategy", "list_bugs", "list_model_tasks", "list_serve_tasks",
    "list_strategies", "list_train_tasks", "register_strategy", "Report",
    "VERDICTS", "capture_task", "run_spec", "verify", "function_spec",
    "run_functions", "verify_functions", "Suite", "SuiteResult", "SuiteTask",
]

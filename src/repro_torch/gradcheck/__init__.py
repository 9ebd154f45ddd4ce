"""repro_torch.gradcheck — distributed training-step verification.

The forward families verify what a rank computes; most real distribution
bugs bite in the *backward* pass — wrong-axis gradient psums, stale ZeRO
shards, mis-normalized accumulation (the TTrace / LLM-framework bug-study
classes in PAPERS.md).  This subsystem verifies the training step itself:

    from repro_torch.gradcheck import check_train
    report = check_train("dp_accum")              # -> TrainReport, on cuda
    report = check_train("dp_accum", device="cpu")
    report = check_train("fsdp", bug="stale_grad_shard", degree=2)
    report.failing_params                         # ["w2"] — localized

Pipeline:

  * ``capture_grad``   captures backward graphs via ``torch.func.grad``
                       over the existing ``repro_torch.core.capture``
                       machinery, in ``jax.grad``'s backward form — the
                       backward pass is just more operators.
  * ``transpose``      derives gradient relations by *transposing* the
                       forward relations: a sharded forward input owes a
                       psum/reduce_scatter gradient collective, a
                       replicated one transposes to identity; the inferred
                       R_o must equal the transposed relation (seam).
  * ``obligations``    the ``train@strategy`` registry — per-parameter
                       gradient obligations for dp, dp_accum (microbatch
                       accumulation), fsdp (ZeRO-3), and tp_dp_2d
                       strategies, plus the three injected gradient bug
                       classes.
  * ``schedule``       fans obligations across the Suite-style worker
                       pool and stitches per-parameter reports into one
                       :class:`TrainReport`.
  * ``report``         the nested, JSON-ready verdict (schema-versioned,
                       per-parameter localization).
"""
from .capture_grad import (capture_backward, capture_grad,
                           capture_grad_spmd, capture_train_task, grad_of)
from .obligations import (TRAIN_STRATEGIES, TrainStrategy,
                          get_train_strategy, list_train_bugs,
                          list_train_strategies, register_train_strategy)
from .report import TRAIN_REPORT_SCHEMA, ParamResult, TrainReport
from .schedule import check_train, replay_train, run_train_obligations
from .transpose import expected_grad_relation, grad_collective

__all__ = [
    "capture_backward", "capture_grad", "capture_grad_spmd",
    "capture_train_task", "grad_of",
    "TRAIN_STRATEGIES", "TrainStrategy", "get_train_strategy",
    "list_train_bugs", "list_train_strategies", "register_train_strategy",
    "TRAIN_REPORT_SCHEMA", "ParamResult", "TrainReport",
    "check_train", "replay_train", "run_train_obligations",
    "expected_grad_relation", "grad_collective",
]

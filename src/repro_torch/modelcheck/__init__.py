"""repro_torch.modelcheck — whole-model refinement verification.

The paper's headline claim is scale: GraphGuard verifies *full model*
deployments, not single layers.  This subsystem gets there the same way
production graph verifiers do (PAPERS.md: "Verifying Computational Graphs
in Production-Grade Distributed Machine Learning Frameworks"): layer-wise
decomposition plus structural deduplication.

    from repro_torch.modelcheck import check_model
    report = check_model("gpt", "dp2xtp2")        # -> ModelReport, on cuda
    report = check_model("gpt", "dp2", device="cpu")
    report.dedup_ratio                            # 14 blocks / 3 obligations

Pipeline:

  * ``decompose``    slices a (model config, mesh plan) pair into per-block
                     verification obligations — embedding, each
                     transformer/MoE block, head — with R_i derived from
                     the plan's ``PartitionSpec``s and block *k*'s output
                     spec chained as block *k+1*'s input spec.
  * ``obligations``  canonicalizes obligations by structure + shapes +
                     specs (never layer index), so N identical transformer
                     layers cost one verification.
  * ``schedule``     fans the unique obligations across a process pool
                     (the ``repro_torch.api.Suite`` worker model) or runs
                     them in-process, tracing on one device.
  * ``stitch``       checks the seams (each block's inferred R_o must be
                     the relation its output spec promises the next block)
                     and assembles per-obligation certificates into one
                     :class:`ModelReport`.

Bug injection: ``check_model(..., bug="wrong_spec", bug_layer=k)`` shards
layer *k*'s MLP down-projection over the wrong mesh axis; the obligation
for that layer stops deduplicating against its siblings and the
``ModelReport`` localizes the refinement error to block *k*.
"""
from .decompose import (FAMILY_SUPPORT, ModelCheckError, decompose,
                        list_model_ids, supported_models)
from .obligations import Obligation, ObligationSet, canonical_key
from .report import MODEL_REPORT_SCHEMA, BlockResult, ModelReport
from .schedule import check_model, run_obligations
from .stitch import expected_output_relation, stitch

__all__ = [
    "FAMILY_SUPPORT", "ModelCheckError", "decompose", "list_model_ids",
    "supported_models", "Obligation", "ObligationSet", "canonical_key",
    "MODEL_REPORT_SCHEMA", "BlockResult", "ModelReport", "check_model",
    "run_obligations", "expected_output_relation", "stitch",
]

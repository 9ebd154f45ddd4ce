"""Stitching: seam contracts + per-obligation reports -> ModelReport.

The decomposer chains block *k*'s output ``PartitionSpec`` as block
*k+1*'s input spec, so the whole-model argument is sound iff every block's
*inferred* R_o is exactly the relation its output spec promises the next
block (the same nested-concat construction ``derive_input_relation``
performs on inputs, applied to the block's distributed outputs).  The seam
check runs at verification time (``schedule._verify_obligation``) where
the captured G_d is in hand; this module builds the expected relation and
assembles the final :class:`ModelReport`.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

from ..core.capture import Graph, derive_input_relation
from ..core.explain import aggregate_explanations
from .decompose import Decomposition
from .report import BlockResult, ModelReport


def expected_output_relation(base_name: str, local_shape, dtype: str,
                             spec, mesh_axes: dict):
    """The clean Term a block's output spec promises: the nested concat of
    per-rank outputs over the sharded mesh axes, at replica coordinate 0 of
    the unsharded ones (the engine's deterministic extraction picks the
    lexicographically-first replica, which is the same choice)."""
    axis_names = tuple(mesh_axes)
    sizes = tuple(mesh_axes[a] for a in axis_names)
    coords = list(itertools.product(*[range(s) for s in sizes]))
    g = Graph([base_name], [], [], {base_name: tuple(local_shape)},
              {base_name: dtype})
    r = derive_input_relation(g, [spec], axis_names, sizes, coords)
    return r[base_name][0]


def stitch(dec: Decomposition, reports: Dict[str, dict], wall_s: float,
           workers: int, cache_stats: Dict = None,
           pool: Dict = None) -> ModelReport:
    """Assemble per-obligation reports into the whole-model verdict.

    Per-block verdicts come from the dedup cache (``reports`` is keyed by
    obligation key); a block is ``cached`` when an earlier block already
    paid for its obligation.  The model verdict is the worst block verdict
    (error > refinement_error > seam mismatch > certificate), and ``ok``
    encodes the run's expectation: a clean run must certify end-to-end,
    a bug run must localize to exactly the injected block.
    """
    blocks: List[BlockResult] = []
    failing: List[int] = []
    seen: set = set()
    gs_ops_total = 0                     # whole-model G_s op count: each
    for i, (name, key) in enumerate(dec.obset.blocks):
        rep = reports[key]               # block costs its obligation's ops,
        ob = dec.obset.unique[key]       # cache hit or not (no re-tracing)
        gs_ops_total += (rep.get("stats") or {}).get("gs_ops", 0)
        seams = rep.get("seams") or []
        seam_ok = all(s["ok"] for s in seams) if seams else \
            rep["verdict"] == "certificate"
        blocks.append(BlockResult(
            index=i, name=name, kind=ob.kind, obligation=key,
            verdict=rep["verdict"], cached=key in seen, seam_ok=seam_ok))
        seen.add(key)
        if rep["verdict"] != "certificate" or not seam_ok:
            failing.append(i)

    verdicts = {b.verdict for b in blocks}
    if verdicts & {"error", "timeout"}:
        verdict = "error"
    elif "refinement_error" in verdicts:
        verdict = "refinement_error"
    elif any(not b.seam_ok for b in blocks):
        verdict = "unexpected_relation"
    else:
        verdict = "certificate"

    if dec.bug is None:
        ok = verdict == "certificate"
    else:
        # the injected bug must be localized to exactly its block:
        # block 0 is the embedding, so layer k is block k+1
        ok = (verdict == "refinement_error"
              and failing == [1 + dec.bug_layer])

    return ModelReport(
        model=dec.model, plan=dec.plan.name, verdict=verdict, ok=ok,
        total_blocks=dec.total_blocks, unique_obligations=dec.n_unique,
        dedup_ratio=round(dec.dedup_ratio, 3), blocks=blocks,
        reports=dict(reports), failing_blocks=failing,
        bug=dec.bug, bug_layer=dec.bug_layer,
        gs_ops_total=gs_ops_total, wall_s=round(wall_s, 6), workers=workers,
        cache=cache_stats, pool=pool,
        explanation=aggregate_explanations(reports))

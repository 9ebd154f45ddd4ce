"""KV-cache sharding relations derived from a :class:`MeshPlan`.

A serving KV cache is a ``(seq, feat)`` buffer per layer: rows are token
positions, columns are (flattened) head features.  The two production
layouts shard exactly one of those dims:

  ``heads``  tensor-parallel serving — every rank holds every position but
             only its head slice (``cache_feat`` -> ``tp``).  Reads gather
             on the feature dim; writes are purely local.
  ``seq``    sequence-parallel cache — every rank owns a contiguous block
             of positions (``cache_seq`` -> the sequence axis).  Writes are
             rank-conditional (only the owner's ``dynamic_update_slice``
             lands); reads gather on the position dim.

``cache_rules`` extends the plan's logical-axis table with the two cache
axes, so obligations derive the cache ``PartitionSpec`` (and hence R_i /
the expected R_o) from the *same* ``MeshPlan`` vocabulary modelcheck uses
for weights and activations, rather than hand-writing specs per strategy.
``cache_relation`` turns the spec into the concrete clean Term the
scheduler's seam check compares against (identical machinery to
modelcheck's block seams).
"""
from __future__ import annotations

from ..core.spmd import PartitionSpec
from ..modelcheck.stitch import expected_output_relation
from ..sharding.specs import MeshPlan, ShardingRules, plan_rules

# logical axes of a (seq, feat) KV-cache buffer
CACHE_AXES = ("cache_seq", "cache_feat")

CACHE_LAYOUTS = ("heads", "seq")


def seq_parallel_plan(degree: int) -> MeshPlan:
    """A one-axis ``sp`` mesh plan for sequence-parallel caches.

    ``parse_plan`` deliberately restricts CLI tokens to dp/tp; the cache
    sequence axis is a serving-only concept, so servecheck constructs the
    plan directly — weights stay replicated (every rule maps to None) and
    only the cache axes (added by :func:`cache_rules`) touch the mesh.
    """
    if degree < 2:
        raise ValueError(f"sp plan needs degree >= 2, got {degree}")
    return MeshPlan(f"sp{degree}", (("sp", degree),), plan_rules({}))


def cache_rules(plan: MeshPlan, layout: str) -> ShardingRules:
    """The plan's logical-axis rules extended with the KV-cache axes."""
    if layout not in CACHE_LAYOUTS:
        raise ValueError(f"cache layout must be one of {CACHE_LAYOUTS}, "
                         f"got {layout!r}")
    axes = plan.mesh_axes
    tp = "tp" if "tp" in axes else None
    sp = "sp" if "sp" in axes else None
    if layout == "heads":
        return plan.rules.with_(cache_seq=None, cache_feat=tp)
    return plan.rules.with_(cache_seq=sp or tp, cache_feat=None)


def cache_spec(plan: MeshPlan, layout: str) -> PartitionSpec:
    """PartitionSpec of a (seq, feat) cache buffer under the plan."""
    return cache_rules(plan, layout).spec_for(CACHE_AXES)


def cache_relation(base_name: str, local_shape, dtype: str, plan: MeshPlan,
                   layout: str):
    """The clean Term a cache's spec promises: the nested per-rank concat
    (sharded dims) at replica coordinate 0 (unsharded dims) — what the
    scheduler's seam check compares the inferred R_o against."""
    return expected_output_relation(base_name, local_shape, dtype,
                                    cache_spec(plan, layout),
                                    plan.mesh_axes)

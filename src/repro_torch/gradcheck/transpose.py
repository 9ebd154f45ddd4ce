"""Gradient relations by *transposing* forward relations.

The forward input relation R_i is derived from each input's
``PartitionSpec`` (``derive_input_relation``).  The gradient side needs no
new derivation machinery — gradient relations are the forward relations
*transposed*, in the AD sense (the backward map is the linear transpose of
the forward map):

  * a dim sharded over mesh axis ``a`` (forward: global = concat of
    shards) transposes to a gradient sharded the same way — the
    post-collective gradient relation is the *same* nested concat;
  * an axis the parameter is replicated over while the loss data is
    sharded over it (forward: broadcast onto the ranks) transposes to a
    cross-rank *sum* — the implementation owes a ``psum`` over that axis
    before its gradient equals the sequential one;
  * an axis the parameter is sharded over while the backward partials are
    computed rank-locally (ZeRO) transposes to ``reduce_scatter``: sum
    over the group, keep your shard.

``grad_collective`` names the collective a strategy owes per parameter;
``expected_grad_relation`` builds the clean Term the inferred R_o must
equal once that collective ran (the gradcheck seam check, mirroring
``modelcheck.stitch.expected_output_relation``).
"""
from __future__ import annotations

import itertools
from typing import Tuple

from ..core.capture import Graph, derive_input_relation


def _spec_axes(spec) -> Tuple[str, ...]:
    """Mesh axes a PartitionSpec shards over (flattened, ordered)."""
    out = []
    for entry in tuple(spec) if spec is not None else ():
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out.append(a)
    return tuple(out)


def grad_collective(param_spec, data_spec, mesh_axes: dict
                    ) -> Tuple[str, Tuple[str, ...]]:
    """The collective the parameter gradient owes, by transposition.

    Returns ``(kind, axes)`` with ``kind`` one of:

      ``"identity"``        nothing owed — every reduction axis of the loss
                            is already local (fully-sharded parameter whose
                            partials are rank-exact)
      ``"psum"``            all-reduce over ``axes`` (replicated parameter,
                            data sharded over those axes)
      ``"reduce_scatter"``  sum over ``axes`` then keep the local shard
                            (ZeRO: the parameter itself is sharded over the
                            same axes the backward partial-sums over)
    """
    p_axes = set(_spec_axes(param_spec))
    d_axes = set(_spec_axes(data_spec))
    # axes the backward partial-sums over: every axis the loss data is
    # sharded over (each rank sees a batch shard, so its local gradient is
    # a partial sum), plus replicated-compute axes contribute nothing.
    reduce_axes = tuple(a for a in mesh_axes if a in d_axes)
    if not reduce_axes:
        return "identity", ()
    if p_axes & set(reduce_axes):
        return "reduce_scatter", reduce_axes
    return "psum", reduce_axes


def expected_grad_relation(base_name: str, local_shape, dtype: str,
                           param_spec, mesh_axes: dict):
    """The clean Term the parameter's inferred gradient R_o must equal.

    By transposition the *post-collective* gradient is sharded exactly
    like the parameter, so the expected relation is the same nested
    concat the forward spec induces (replica coordinate 0 on unsharded
    axes — the engine's deterministic extraction makes the same choice).
    """
    axis_names = tuple(mesh_axes)
    sizes = tuple(mesh_axes[a] for a in axis_names)
    coords = list(itertools.product(*[range(s) for s in sizes]))
    g = Graph([base_name], [], [], {base_name: tuple(local_shape)},
              {base_name: dtype})
    r = derive_input_relation(g, [param_spec], axis_names, sizes, coords)
    return r[base_name][0]

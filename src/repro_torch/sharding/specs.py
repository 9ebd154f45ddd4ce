"""Logical-axis sharding: rules mapping logical tensor axes to mesh axes.

Model code names its tensor axes logically ("batch", "embed", "heads",
...). A ``ShardingRules`` table maps those names to mesh axes, and
``spec_for`` builds the :class:`repro_torch.core.spmd.PartitionSpec` of a
tensor from its logical axes. A :class:`MeshPlan` bundles an ordered mesh
with its rules; ``repro_torch.modelcheck`` derives every obligation's
input specs from one.

This is the pure part of the JAX package's ``sharding/specs.py``. Its
mesh part (``use_sharding``, ``active_mesh``, ``constrain`` and
``tree_shardings``, which place tensors on a live device mesh) comes with
the port's ``DeviceMesh`` (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Union

from ..core.spmd import PartitionSpec

Axis = Union[None, str, tuple]


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""
    rules: dict

    def spec_for(self, logical_axes: tuple) -> PartitionSpec:
        entries = []
        for ax in logical_axes:
            if ax is None:
                entries.append(None)
            else:
                entries.append(self.rules.get(ax))
        return PartitionSpec(*entries)

    def with_(self, **updates) -> "ShardingRules":
        d = dict(self.rules)
        d.update(updates)
        return ShardingRules(d)


# The baseline production plan: data-parallel batch over (pod, data),
# tensor-parallel model dims over model; parameters ZeRO/FSDP-sharded over
# data on their non-tensor dim ("embed_fsdp" is used for *parameters only*).
def default_rules(multi_pod: bool = False, fsdp: bool = True) -> ShardingRules:
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules({
        "batch": data_axes,
        "seq": None,
        "embed": None,
        "embed_fsdp": "data" if fsdp else None,   # parameter-only dim
        "heads": "model",
        "kv_heads": "model",
        "qheads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ff": None,
        "expert_fsdp": "data" if fsdp else None,
        "act_ff": "model",       # activation hidden dim (TP)
        "act_heads": "model",    # activation heads dim (TP)
        "layers": None,
        "state": None,
        "kv_seq": None,
        "conv": None,
    })


# ---------------------------------------------------------------------------
# Mesh plans (modelcheck): a named mesh + logical-axis rules in one object
# ---------------------------------------------------------------------------

# Logical-axis rules for the whole-model verification plans: batch over the
# data axis, tensor dims (heads / ff / vocab / experts) over the model axis,
# parameters unsharded on their embed dim (pure Megatron TP — no ZeRO, so
# block programs need no weight gathers).  ``embed_tp`` is the embedding
# table's feature dim: sharding it (rather than vocab) keeps the gather
# local and assembles the activation with one all_gather, staying inside
# the lemma fragment (vocab-parallel embedding needs a value-dependent
# masked gather, which no symbolic engine can verify).
def plan_rules(axes: dict) -> ShardingRules:
    dp = "dp" if "dp" in axes else None
    tp = "tp" if "tp" in axes else None
    return ShardingRules({
        "batch": dp,
        "seq": None,
        "embed": None,
        "embed_fsdp": None,
        "embed_tp": tp,
        "vocab_rows": None,  # embedding-table rows (gather stays local)
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "vocab": tp,
        "experts": tp,
        "act_ff": tp,
        "act_heads": tp,
        "layers": None,
    })


@dataclass(frozen=True)
class MeshPlan:
    """A named sharding plan: ordered mesh axes + logical-axis rules.

    ``repro_torch.modelcheck`` derives every obligation's ``in_specs`` (and
    thus R_i) from the plan: parameter/activation leaf specs carry
    *logical* axis names and ``spec_for`` maps them through the rules."""
    name: str
    axes: tuple                          # (("dp", 2), ("tp", 2)) — ordered
    rules: ShardingRules

    @property
    def mesh_axes(self) -> dict:
        return dict(self.axes)

    @property
    def degree(self) -> tuple:
        return tuple(s for _, s in self.axes)

    def axis(self, name: str) -> int:
        return self.mesh_axes.get(name, 1)

    def spec_for(self, logical_axes: tuple) -> PartitionSpec:
        return self.rules.spec_for(tuple(logical_axes))


PLAN_AXES = ("dp", "tp")


def parse_plan(token: str) -> MeshPlan:
    """Parse a plan token like ``dp2``, ``tp4`` or ``dp2xtp2`` into a
    :class:`MeshPlan` (axis order is as written; sizes must be >= 2 — an
    absent axis is simply not in the mesh)."""
    axes = []
    for part in str(token).split("x"):
        m = re.fullmatch(r"([a-z]+)(\d+)", part)
        if not m or m.group(1) not in PLAN_AXES:
            raise ValueError(
                f"bad plan {token!r} — expected parts like `dp2`/`tp4` "
                f"joined by `x` (axes: {PLAN_AXES})")
        name, size = m.group(1), int(m.group(2))
        if size < 2:
            raise ValueError(f"bad plan {token!r}: axis {name} needs "
                             f"size >= 2 (drop the axis instead of size 1)")
        if any(a == name for a, _ in axes):
            raise ValueError(f"bad plan {token!r}: duplicate axis {name}")
        axes.append((name, size))
    if not axes:
        raise ValueError(f"bad plan {token!r}: no mesh axes")
    axes = tuple(axes)
    return MeshPlan(token, axes, plan_rules(dict(axes)))


# The named plans the modelcheck CLI sweeps by default.  tp4 parses and
# certifies too (the n-ary add normal form keeps its 4-wide psum chains
# tractable).
DEFAULT_PLANS = ("dp2", "tp2", "dp2xtp2", "dp4")

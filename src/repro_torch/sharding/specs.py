"""Logical-axis sharding: rules mapping logical tensor axes to mesh axes.

Model code names its tensor axes logically ("batch", "embed", "heads",
...). A ``ShardingRules`` table maps those names to mesh axes, and
``spec_for`` builds the :class:`repro_torch.core.spmd.PartitionSpec` of a
tensor from its logical axes. A :class:`MeshPlan` bundles an ordered mesh
with its rules; ``repro_torch.modelcheck`` derives every obligation's
input specs from one.

The mesh part places tensors on a ``torch.distributed`` ``DeviceMesh``
as DTensors: ``use_sharding(mesh, rules)`` makes a mesh and its rules
active for the thread (and lets plain tensors that model code makes, such
as ``arange`` positions, join DTensor ops as replicated);
``placements_for`` turns a ``PartitionSpec`` into DTensor placements;
``constrain`` is the JAX ``with_sharding_constraint``, a ``redistribute``
of a DTensor and the identity otherwise; ``tree_shardings`` maps a tree of
logical axes to placements, and ``distribute_params`` places a model's
parameters. ``local_region`` runs a function on local shards where
DTensor has no sharding rule for its ops. ``torch.distributed.tensor``
is imported where it is first needed (it takes about a second), so a
process that never makes a mesh does not pay for it.
"""
from __future__ import annotations

import contextlib
import re
import sys
import threading
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor

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


# ---------------------------------------------------------------------------
# The mesh part: a DeviceMesh, DTensor placements, the active context
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor (none exists
    before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def is_wrapped(x) -> bool:
    """Whether ``x`` is a DTensor or a fake tensor (the dry run's
    ``FakeTensorMode``): a tensor whose ops its subclass dispatches, which
    no hand-written kernel takes."""
    return isinstance(x, FakeTensor) or is_dtensor(x)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[ShardingRules] = None


_ctx = _Ctx()
# DTensor's implicit-replication context manager sets its flag on entry
# and clears it on exit, whatever it was: it is entered once, while any
# use_sharding is active, so that a nested one (remat's recompute, also
# on autograd's device thread) does not clear it under the outer one
_implicit = {"depth": 0, "cm": None}
_implicit_lock = threading.Lock()


@contextlib.contextmanager
def _replicate_plain_tensors():
    from torch.distributed.tensor.experimental import implicit_replication
    with _implicit_lock:
        if _implicit["depth"] == 0:
            _implicit["cm"] = implicit_replication()
            _implicit["cm"].__enter__()
        _implicit["depth"] += 1
    try:
        yield
    finally:
        with _implicit_lock:
            _implicit["depth"] -= 1
            if _implicit["depth"] == 0:
                _implicit["cm"].__exit__(None, None, None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[ShardingRules]):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) and ``rules`` the
    thread's; with a mesh, plain tensors meeting DTensors in an op are
    taken as replicated."""
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh, _ctx.rules = mesh, rules
    try:
        with _replicate_plain_tensors() if mesh is not None \
                else contextlib.nullcontext():
            yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def active_mesh():
    return _ctx.mesh


def active_rules() -> Optional[ShardingRules]:
    return _ctx.rules


def placements_for(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements, one per mesh dim, for ``spec``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names (a tuple of names shards d
    over each, the first name outermost, as in JAX), ``Replicate()`` on
    the others. Rank 0's shard has JAX's shard shape: both round a dim up
    (JAX pads the last shard, DTensor leaves it short)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: mesh axes {axes} on one dim must "
                             f"follow the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} on two dims")
            out[i] = Shard(d)
    return tuple(out)


def local_box(shape, mesh, placements) -> list:
    """This rank's shard of a tensor of ``shape``: (start, size) a dim, as
    DTensor cuts each sharded dim (``torch.chunk``'s ceil-sized pieces,
    the last ones short or empty), mesh dim by mesh dim."""
    coord = mesh.get_coordinate()
    box = [(0, n) for n in shape]
    for i, p in enumerate(placements):
        if p.is_shard():
            start, n = box[p.dim]
            size = -(-n // mesh.size(i))
            off = min(coord[i] * size, n)
            box[p.dim] = (start + off, min(size, n - off))
    return box


def constrain(x, logical_axes: tuple):
    """Redistribute a DTensor to the placements the active rules give
    ``logical_axes``; the identity without a mesh or for a plain tensor.
    The local shard comes back contiguous, and so does its gradient's
    (gathering an uneven shard leaves a slice of a padded buffer, which a
    later view cannot take)."""
    if _ctx.mesh is None or _ctx.rules is None or not is_dtensor(x):
        return x
    if x.requires_grad:
        x.register_hook(_contiguous_shard)
    return _contiguous_shard(x.redistribute(x.device_mesh, placements_for(
        x.device_mesh, _ctx.rules.spec_for(logical_axes))))


def _contiguous_shard(x):
    """``x`` (a DTensor) with a contiguous local shard (``x.contiguous()``
    would look at the global strides, which are contiguous, and not touch
    the shard)."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def reduce_partial(x):
    """A DTensor's pending (partial) reductions done, its shards kept;
    anything else as it is. A gather from a vocab-sharded tensor leaves a
    masked partial sum whose reduction must come before its shape
    changes."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def _is_axes_leaf(x):
    """A logical-axes leaf is a tuple of axis names / None — NOT a tuple of
    tuples (e.g. a (k, v) cache pair), which is tree structure."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_map_axes(fn, logical_tree):
    """``fn`` on every logical-axes leaf of a tree of dicts, lists and
    tuples, keeping its structure."""
    if _is_axes_leaf(logical_tree):
        return fn(logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_map_axes(fn, v) for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(tree_map_axes(fn, v) for v in logical_tree)
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


def tree_shardings(mesh, rules: ShardingRules, logical_tree):
    """Map a tree of logical-axis tuples to DTensor placements."""
    return tree_map_axes(
        lambda axes: placements_for(mesh, rules.spec_for(axes)), logical_tree)


def distribute(t: torch.Tensor, mesh, placements, device=None):
    """``t`` as a DTensor with ``placements``, cut locally with no
    collective (every rank holds the same ``t``). A tensor on the meta
    device gets a new local shard on ``device`` (the mesh's device type by
    default), uninitialised: under ``FakeTensorMode``, a fake one."""
    from torch.distributed.tensor import DTensor
    box = local_box(t.shape, mesh, placements)
    if t.device.type == "meta":
        local = torch.empty([n for _, n in box], dtype=t.dtype,
                            device=device or mesh.device_type)
    else:
        local = t
        for d, (start, n) in enumerate(box):
            local = local.narrow(d, start, n)
        local = local.contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


@torch.no_grad()
def distribute_params(model: nn.Module, mesh, rules: ShardingRules,
                      device=None) -> nn.Module:
    """Replace each spec'd parameter of ``model`` (the ``Leaf``s of its
    ``Params`` modules) by a DTensor placed by its logical axes; returns
    the model. A parameter that is one shard (a one-rank mesh) keeps its
    storage."""
    from ..models import layers as L
    for mod in model.modules():
        if not isinstance(mod, L.Params):
            continue
        for name, lf in mod.leaves.items():
            p = getattr(mod, name)
            pl = placements_for(mesh, rules.spec_for(lf.logical))
            setattr(mod, name, nn.Parameter(distribute(p.data, mesh, pl,
                                                       device),
                                            requires_grad=p.requires_grad))
    return model


def local_region(fn, in_axes, out_axes):
    """``fn`` run on local shards where DTensor has no rule for its ops.

    ``in_axes`` and ``out_axes`` give each tensor argument's and output's
    logical axes (None for a non-tensor argument); under an active mesh the
    arguments are redistributed to the rules' placements for them, ``fn``
    runs on the local tensors and its outputs come back as DTensors with
    the placements of ``out_axes``. An argument replicated over a mesh dim
    that an output is sharded over gets its gradient as a partial sum
    there (each rank's is its shard's part). Without a mesh, ``fn``
    itself."""
    def wrapped(*args):
        mesh, rules = _ctx.mesh, _ctx.rules
        if mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map
        pl = lambda axes: None if axes is None else \
            placements_for(mesh, rules.spec_for(axes))  # noqa: E731
        single = _is_axes_leaf(out_axes)
        out_pl = [pl(out_axes)] if single else [pl(a) for a in out_axes]
        sharded = {i for o in out_pl for i, p in enumerate(o) if p.is_shard()}
        in_pl = tuple(pl(a) for a in in_axes)
        grad_pl = tuple(None if p is None else tuple(
            Partial() if i in sharded and q.is_replicate() else q
            for i, q in enumerate(p)) for p in in_pl)
        # one output: a list of placements; several: a tuple of them
        return local_map(fn, out_placements=list(out_pl[0]) if single
                         else tuple(out_pl), in_placements=in_pl,
                         in_grad_placements=grad_pl, device_mesh=mesh,
                         redistribute_inputs=True)(*args)
    return wrapped


def heads_local(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` of an attention on local shards, for DTensor
    q (B, S, H, hd) and k, v (B, Sk, KV, hd): q keeps its batch and heads
    shards (anything else gathered), k and v their batch shard and, where
    the KV heads divide over q's heads shards, the same heads shards (a
    rank's q heads read exactly its KV heads); otherwise k and v are
    gathered over the heads' mesh dims and cut to the KV heads the rank's
    q heads read (query head h reads KV head h // G) by its coordinate
    there, the GQA case DTensor has no rule for (KV heads replicated when
    they do not divide the mesh axis). DTensors in ``rest`` are
    replicated, plain tensors passed as they are. The output is placed
    as q."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in q.placements)
    dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    n = 1
    for d in dims:
        n *= mesh.size(d)
    hl = H // n
    if H % n or (hl % G and G % hl):
        raise ValueError(f"{H} q heads over {n} ranks do not cover whole "
                         f"groups of {G} (KV {KV})")
    aligned = KV % n == 0
    kv_pl = tuple(p if p == Shard(0) or (aligned and p == Shard(2))
                  else Replicate() for p in q_pl)

    def local(ql, kl, vl, *r):
        if dims and not aligned:
            c = 0
            for d in dims:
                c = c * mesh.size(d) + mesh.get_local_rank(d)
            k0, k1 = c * hl // G, (c * hl + hl - 1) // G + 1
            kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
        return fn(ql, kl, vl, *r)

    rest_pl = tuple((Replicate(),) * mesh.ndim if is_dtensor(x) else None
                    for x in rest)
    # k's and v's gradients, gathered: each rank's for the KV heads it
    # read, summed over the ranks that share them
    kv_grad = tuple(Partial() if i in dims and not aligned else p
                    for i, p in enumerate(kv_pl))
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl) + rest_pl,
                     in_grad_placements=(q_pl, kv_grad, kv_grad) + rest_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, *rest)

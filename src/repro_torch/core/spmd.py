"""The SPMD shim a torch case is written against.

The JAX package writes a per-rank program with ``jax.lax`` collectives and
traces it under ``shard_map``. This module gives torch code the same
vocabulary:

* :class:`PartitionSpec` (``P``) — one entry per tensor dim: ``None``
  (replicated), a mesh axis name, or a tuple of names (major to minor).
* :func:`shard_map` — wraps a per-rank function with its mesh and input
  specs; ``capture_spmd`` reads them off the wrapper.
* the collectives ``psum``, ``all_gather``, ``psum_scatter``,
  ``all_to_all``, ``ppermute`` and ``axis_index``, plus
  ``dynamic_slice``/``dynamic_update_slice``, whose starts may be tensors
  computed from ``axis_index`` (``narrow`` needs an int).

Each is a ``torch.library.custom_op`` under the ``repro_spmd`` namespace,
so ``make_fx`` records it as one node and the capture lowers it to the
term of the same name; ``expand_spmd`` then turns it into cross-rank ops.
Their real implementations only produce the right shapes and dtypes (the
trace runs one rank-agnostic program), and each has a fake implementation.
Axis names travel as one comma-joined string (``custom_op`` takes no list
of strings). The names of ``torch.distributed._functional_collectives``
(``all_reduce``, ``all_gather_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``permute_tensor``) map onto the same ops, with a
mesh axis name (or tuple of names) as the group.

The group sizes come from the mesh of the enclosing :func:`mesh` block,
which ``shard_map`` wrappers and ``capture_spmd`` open.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence, Union

import torch

NAMESPACE = "repro_spmd"
AxisNames = Union[str, Sequence[str]]


class PartitionSpec(tuple):
    """Per-dim sharding of one input: ``None``, an axis name, or a tuple of
    axis names (major to minor). Missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_MESH: list = []


@contextlib.contextmanager
def mesh(mesh_axes: dict) -> Iterator[dict]:
    """Make ``mesh_axes`` ({axis name: size}) the mesh the collectives'
    group sizes are read from."""
    _MESH.append(dict(mesh_axes))
    try:
        yield _MESH[-1]
    finally:
        _MESH.pop()


def _axes(axis_name: AxisNames) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def group_size(axis_name: AxisNames) -> int:
    """Ranks in the group spanned by ``axis_name`` on the current mesh."""
    if not _MESH:
        raise RuntimeError("SPMD collectives run inside a mesh: trace the "
                           "function with capture_spmd or call it through "
                           "shard_map")
    m = _MESH[-1]
    for a in _axes(axis_name):
        if a not in m:
            raise ValueError(f"axis {a!r} is not on the mesh {m}")
    return math.prod(m[a] for a in _axes(axis_name))


def local_shape(shape: Sequence[int], spec, mesh_axes: dict) -> tuple:
    """Per-rank shape of a global ``shape`` sharded by ``spec``."""
    spec = tuple(spec or ())
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        k = 1 if entry is None else math.prod(mesh_axes[a]
                                              for a in _axes(entry))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


@dataclass(frozen=True)
class ShardMap:
    """A per-rank function with its mesh and input specs."""
    fn: Callable
    mesh_axes: dict
    in_specs: tuple

    def __call__(self, *local_args):
        with mesh(self.mesh_axes):
            return self.fn(*local_args)


def shard_map(fn: Callable, mesh_axes: dict, in_specs: Sequence) -> ShardMap:
    """Wrap per-rank ``fn`` with its mesh ({axis: size}) and one
    :class:`PartitionSpec` per input."""
    return ShardMap(fn, dict(mesh_axes), tuple(in_specs))


# ---------------------------------------------------------------------------
# custom ops
# ---------------------------------------------------------------------------

def _op(name: str):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=())


def _gathered_shape(x, dim: int, tiled: bool, size: int) -> list:
    if tiled:
        return [n * size if i == dim else n for i, n in enumerate(x.shape)]
    return list(x.shape[:dim]) + [size] + list(x.shape[dim:])


def _scattered_shape(x, dim: int, size: int) -> list:
    return [n // size if i == dim else n for i, n in enumerate(x.shape)]


def _a2a_shape(x, split: int, concat: int, size: int) -> list:
    out = list(x.shape)
    out[split] //= size
    out[concat] *= size
    return out


def _clamped(starts, shape, sizes) -> list:
    return [min(max(int(s), 0), n - z)
            for s, n, z in zip(starts, shape, sizes)]


@_op("psum")
def _psum(x: torch.Tensor, axes: str) -> torch.Tensor:
    return x.clone()


@_op("all_gather")
def _all_gather(x: torch.Tensor, axes: str, dim: int, tiled: bool,
                size: int) -> torch.Tensor:
    return x.new_zeros(_gathered_shape(x, dim, tiled, size))


@_op("reduce_scatter")
def _reduce_scatter(x: torch.Tensor, axes: str, dim: int,
                    size: int) -> torch.Tensor:
    return x.new_zeros(_scattered_shape(x, dim, size))


@_op("all_to_all")
def _all_to_all(x: torch.Tensor, axes: str, split: int, concat: int,
                size: int) -> torch.Tensor:
    return x.new_zeros(_a2a_shape(x, split, concat, size))


@_op("ppermute")
def _ppermute(x: torch.Tensor, axis: str, perm: list[int]) -> torch.Tensor:
    return x.clone()


@_op("axis_index")
def _axis_index(axis: str) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64)


@_op("dynamic_slice")
def _dynamic_slice(x: torch.Tensor, starts: list[torch.Tensor],
                   sizes: list[int]) -> torch.Tensor:
    out = x
    for d, (s, z) in enumerate(zip(_clamped(starts, x.shape, sizes), sizes)):
        out = out.narrow(d, s, z)
    return out.clone()


@_op("dynamic_update_slice")
def _dynamic_update_slice(x: torch.Tensor, upd: torch.Tensor,
                          starts: list[torch.Tensor]) -> torch.Tensor:
    out = x.clone()
    st = _clamped(starts, x.shape, upd.shape)
    out[tuple(slice(s, s + z) for s, z in zip(st, upd.shape))] = upd
    return out


@_psum.register_fake
def _(x, axes):
    return torch.empty_like(x)


@_all_gather.register_fake
def _(x, axes, dim, tiled, size):
    return x.new_empty(_gathered_shape(x, dim, tiled, size))


@_reduce_scatter.register_fake
def _(x, axes, dim, size):
    return x.new_empty(_scattered_shape(x, dim, size))


@_all_to_all.register_fake
def _(x, axes, split, concat, size):
    return x.new_empty(_a2a_shape(x, split, concat, size))


@_ppermute.register_fake
def _(x, axis, perm):
    return torch.empty_like(x)


@_axis_index.register_fake
def _(axis):
    return torch.empty((), dtype=torch.int64)


@_dynamic_slice.register_fake
def _(x, starts, sizes):
    return x.new_empty(sizes)


@_dynamic_update_slice.register_fake
def _(x, upd, starts):
    return torch.empty_like(x)


# ---------------------------------------------------------------------------
# the vocabulary a per-rank program calls (jax.lax names)
# ---------------------------------------------------------------------------

def _joined(axis_name: AxisNames) -> str:
    return ",".join(_axes(axis_name))


def psum(x: torch.Tensor, axis_name: AxisNames) -> torch.Tensor:
    """All-reduce (sum) over the ranks of ``axis_name`` (one or more axes)."""
    group_size(axis_name)
    return _psum(x, _joined(axis_name))


def all_gather(x: torch.Tensor, axis_name: AxisNames, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Gather every rank's ``x`` along ``axis`` (stacked unless tiled)."""
    return _all_gather(x, _joined(axis_name), axis, tiled,
                       group_size(axis_name))


def psum_scatter(x: torch.Tensor, axis_name: AxisNames, *,
                 scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """Reduce-scatter: sum over the group, keep this rank's block."""
    if not tiled:
        raise ValueError("only tiled psum_scatter is supported")
    return _reduce_scatter(x, _joined(axis_name), scatter_dimension,
                           group_size(axis_name))


def all_to_all(x: torch.Tensor, axis_name: AxisNames, split_axis: int,
               concat_axis: int, *, tiled: bool = True) -> torch.Tensor:
    """Split ``x`` over the group on ``split_axis``, concat what arrives on
    ``concat_axis``."""
    if not tiled:
        raise ValueError("only tiled all_to_all is supported")
    return _all_to_all(x, _joined(axis_name), split_axis, concat_axis,
                       group_size(axis_name))


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[tuple]) -> torch.Tensor:
    """Send ``x`` from rank ``src`` to rank ``dst`` for each pair of
    ``perm``; a rank no pair sends to receives zeros."""
    if not isinstance(axis_name, str):
        names = tuple(axis_name)
        if len(names) != 1:
            raise ValueError("multi-axis ppermute is unsupported")
        axis_name = names[0]
    group_size(axis_name)
    return _ppermute(x, axis_name, [int(i) for pair in perm for i in pair])


def axis_index(axis_name: str) -> torch.Tensor:
    """This rank's coordinate on ``axis_name`` (a 0-d int64 tensor)."""
    group_size(axis_name)
    return _axis_index(axis_name)


def _index_tensors(starts) -> list:
    return [s if isinstance(s, torch.Tensor)
            else torch.scalar_tensor(int(s), dtype=torch.int64)
            for s in starts]


def dynamic_slice(x: torch.Tensor, start_indices: Sequence,
                  slice_sizes: Sequence[int]) -> torch.Tensor:
    """``x[starts : starts + sizes]`` with starts clamped into range; a
    start may be a tensor (e.g. computed from ``axis_index``)."""
    return _dynamic_slice(x, _index_tensors(start_indices),
                          [int(z) for z in slice_sizes])


def dynamic_update_slice(x: torch.Tensor, update: torch.Tensor,
                         start_indices: Sequence) -> torch.Tensor:
    """A copy of ``x`` with ``update`` written at ``start_indices``."""
    return _dynamic_update_slice(x, update, _index_tensors(start_indices))


# ---------------------------------------------------------------------------
# torch.distributed._functional_collectives names, with mesh axes as groups
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, reduceOp: str,
               group: AxisNames) -> torch.Tensor:
    """``funcol.all_reduce``; only ``"sum"`` has a term."""
    if str(reduceOp).lower() != "sum":
        raise ValueError(f"all_reduce {reduceOp!r}: only sum is supported")
    return psum(x, group)


def all_gather_tensor(x: torch.Tensor, gather_dim: int,
                      group: AxisNames) -> torch.Tensor:
    """``funcol.all_gather_tensor``: a tiled gather along ``gather_dim``."""
    return all_gather(x, group, axis=gather_dim, tiled=True)


def reduce_scatter_tensor(x: torch.Tensor, reduceOp: str, scatter_dim: int,
                          group: AxisNames) -> torch.Tensor:
    """``funcol.reduce_scatter_tensor``; only ``"sum"`` has a term."""
    if str(reduceOp).lower() != "sum":
        raise ValueError(f"reduce_scatter_tensor {reduceOp!r}: only sum "
                         f"is supported")
    return psum_scatter(x, group, scatter_dimension=scatter_dim, tiled=True)


def all_to_all_single(x: torch.Tensor, output_split_sizes: Optional[list],
                      input_split_sizes: Optional[list],
                      group: AxisNames) -> torch.Tensor:
    """``funcol.all_to_all_single`` with even splits on dim 0."""
    if output_split_sizes is not None or input_split_sizes is not None:
        raise ValueError("all_to_all_single: only even splits are supported")
    return all_to_all(x, group, 0, 0)


def permute_tensor(x: torch.Tensor, src_dst: Sequence[int],
                   group: str) -> torch.Tensor:
    """``funcol.permute_tensor``: rank ``i`` sends to ``src_dst[i]``."""
    return ppermute(x, group, [(i, d) for i, d in enumerate(src_dst)])

"""Computation-graph capture: an aten graph from ``make_fx`` -> Graph IR.

The JAX package traces with ``jax.make_jaxpr``; the port traces with
``torch.fx.experimental.proxy_tensor.make_fx`` in ``"real"`` mode, on real
tensors on the requested device (closed-over tensors, such as rotary
tables, become ``get_attr`` constants, which ``"fake"`` mode refuses).
Two capture paths:

  * ``capture(fn, avals, names)`` — the sequential model ``G_s``.
  * ``capture_spmd(fn, mesh_axes, in_specs, avals, names)`` — the per-rank
    program, written against ``repro_torch.core.spmd``, traced once on
    per-shard tensors with its collectives left as symbolic ops.
    ``expand_spmd`` instantiates it once per rank coordinate, folding
    ``axis_index`` to a literal and translating each collective into
    *pure cross-rank ops*:

        psum            ->  add over the rank group
        all_gather      ->  concat over the rank group
        reduce_scatter  ->  slice(add over group, rank block)
        all_to_all      ->  concat of per-source slices
        ppermute        ->  renaming (or zeros for uncovered ranks)

    so the lemma engine never needs to know about communication.

Aten ops map to the term vocabulary of ``terms.py`` as the JAX capture maps
jaxpr primitives, so that the same lemmas fire: ``mm``/``bmm`` become
``matmul``/``bmm``, ``sigmoid`` becomes ``logistic``, ``select`` becomes a
slice and a reshape, ``unsqueeze`` a ``broadcast`` (as ``x[None]`` is in
jax), ``constant_pad_nd`` a concat with broadcast blocks, and scalar
operands are lifted to an explicit ``broadcast`` so elementwise lemmas stay
shape-uniform. 0-d constants (Python scalars, ``scalar_tensor``, 0-d
closed-over tensors) are literals, as jaxpr literals are. Graph constants
stay host numpy arrays, so relation inference matches them exactly
whatever the device. An aten op outside the table raises
``CaptureError``.
"""
from __future__ import annotations

import itertools
import operator
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.fx import traceback as fx_traceback
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode

from ..models.registry import resolve_device
from ..obs import trace as obs_trace
from . import spmd
from . import terms as T
from .terms import Term

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# Graph IR
# ---------------------------------------------------------------------------

@dataclass
class Graph:
    """Straight-line tensor program: ordered ``defs`` of name := Term(leaves
    are previously-defined names / inputs / consts / literals)."""
    inputs: list
    outputs: list
    defs: list          # [(name, Term)]
    shapes: dict        # name -> shape tuple
    dtypes: dict        # name -> 'f' | 'i' | 'b'
    consts: dict = field(default_factory=dict)   # name -> np.ndarray

    def tensor(self, name: str) -> Term:
        return T.tensor(name, self.shapes[name], self.dtypes[name])

    @property
    def n_ops(self) -> int:
        return len(self.defs)


def _dt(dtype) -> str:
    """Term dtype ('f' | 'i' | 'b') of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return "b"
        return "f" if dtype.is_floating_point or dtype.is_complex else "i"
    k = np.dtype(dtype).kind
    return {"f": "f", "b": "b", "i": "i", "u": "i", "V": "f"}.get(k, "f")


class CaptureError(RuntimeError):
    """A traced graph could not be lowered to the term language (an aten op
    outside the table, or an unsupported configuration of one)."""


# Strict-mode hook stack (installed by ``from_fx.strict_capture``): each
# entry is called as ``hook(node, reason)`` right before the capture raises
# ``CaptureError`` for a node it cannot lower, so the strict frontend can
# raise a structured ``UnsupportedPrimitive`` naming the node and the
# user's source location.
_NODE_HOOKS: list = []


def _on_unsupported(node, reason: str) -> None:
    """Notify strict-mode hooks that ``node`` has no term lowering."""
    for hook in reversed(_NODE_HOOKS):
        hook(node, reason)


def op_name(node) -> str:
    """``aten.mm``-style name of a call_function node's target."""
    return _target_name(node.target)


def _target_name(tgt) -> str:
    name = getattr(tgt, "name", None)
    if callable(name):                       # OpOverload.name() -> ns::op.ov
        ns, _, rest = name().partition("::")
        return f"{ns}.{rest.split('.')[0]}"
    return getattr(tgt, "__name__", str(tgt))


def source_location(node) -> str:
    """``file:line (function)`` of the user code that emitted ``node``."""
    return node.meta.get("stack_trace") or "<unknown>"


_SKIP_DIRS = (os.path.dirname(torch.__file__), os.path.dirname(__file__))


class _SourceMode(TorchFunctionMode):
    """Stamp each traced node with the innermost user frame outside torch
    and this capture layer (``node.meta["stack_trace"]``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(_SKIP_DIRS):
            f = f.f_back
        if f is not None:
            fx_traceback.set_stack_trace(
                [f"{f.f_code.co_filename}:{f.f_lineno} ({f.f_code.co_name})"])
        return func(*args, **(kwargs or {}))


def _trace(fn: Callable, args: list):
    with fx_traceback.preserve_node_meta(), _SourceMode():
        return make_fx(fn, tracing_mode="real")(*args)


def _examples(avals: Sequence, device) -> list:
    """The tracing tensors for ``avals`` on ``device``: floating inputs
    drawn in order from one ``torch.Generator`` on the device seeded with
    0, the others zeros (valid as indices). ``make_fx`` runs in real mode,
    so the draw only has to be the same on every run; the graph does not
    depend on it. An ``inputs`` event on the installed tracer records the
    device the tensors were made on."""
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for shape, dtype in avals:
        if dtype.is_floating_point or dtype.is_complex:
            out.append(torch.randn(tuple(shape), generator=gen, dtype=dtype,
                                   device=device))
        else:
            out.append(torch.zeros(tuple(shape), dtype=dtype, device=device))
    obs_trace.event("inputs", cat="capture",
                    device=str(out[0].device) if out else str(device))
    return out


def capture(fn: Callable, avals: Sequence, names: Sequence[str],
            graph_tag: str = "", device=None) -> Graph:
    """Capture ``fn(*args)`` into a Graph. ``avals`` are ``(shape, dtype)``
    pairs; the trace runs on tensors of those shapes on ``device``
    (``cuda`` unless ``"cpu"`` is asked for), made by :func:`_examples`."""
    dev = resolve_device(device)
    gm = _trace(fn, _examples(avals, dev))
    return _fx_to_graph(gm, list(names), graph_tag)


@dataclass
class SpmdCapture:
    """A traced per-rank SPMD program before rank expansion: the single-rank
    graph (collectives still symbolic) plus the mesh and input specs
    ``expand_spmd`` needs to instantiate it per rank and derive R_i."""
    graph: Graph                  # per-rank program with collective ops
    mesh_axes: dict               # axis name -> size
    in_specs: list                # PartitionSpec per input
    names: list


def capture_spmd(fn: Callable, mesh_axes: dict, in_specs: Sequence,
                 avals: Sequence, names: Sequence[str],
                 device=None) -> SpmdCapture:
    """Trace the per-rank ``fn`` (or a ``spmd.shard_map`` wrapper, whose
    mesh and specs must agree) on per-shard tensors of the global
    ``avals`` on ``device`` (``cuda`` unless ``"cpu"`` is asked for; made
    by :func:`_examples`) and lower it to a
    single-rank :class:`Graph` (collectives kept as symbolic
    ops for ``expand_spmd`` to instantiate)."""
    dev = resolve_device(device)
    if isinstance(fn, spmd.ShardMap):
        if dict(fn.mesh_axes) != dict(mesh_axes) \
                or tuple(fn.in_specs) != tuple(in_specs):
            raise ValueError("shard_map wrapper disagrees with the given "
                             "mesh_axes/in_specs")
        fn = fn.fn
    local = [(spmd.local_shape(shape, spec, mesh_axes), dtype)
             for (shape, dtype), spec in zip(avals, in_specs)]
    with spmd.mesh(mesh_axes):
        gm = _trace(fn, _examples(local, dev))
    g = _fx_to_graph(gm, list(names), "")
    return SpmdCapture(g, dict(mesh_axes), list(in_specs), list(names))


def _flat(x) -> list:
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _flat(v)]
    return [x]


def _fx_to_graph(gm, names, tag) -> Graph:
    g = Graph([], [], [], {}, {}, {})
    env: dict = {}
    counter = itertools.count()
    consts_by_target: dict = {}

    def declare(nm: str, shape, dtype: str):
        g.shapes[nm] = tuple(shape)
        g.dtypes[nm] = dtype

    def read(arg) -> Term:
        return env[arg]

    def emit(term: Term) -> Term:
        if term.op == "lit":
            return term               # a literal atom, as in a jaxpr
        nm = f"t{next(counter)}"
        declare(nm, term.shape, term.dtype)
        g.defs.append((nm, term))
        return g.tensor(nm)

    def const(value: np.ndarray) -> Term:
        nm = f"const{len(g.consts)}{tag}"
        g.consts[nm] = value
        declare(nm, value.shape, _dt(value.dtype))
        return g.tensor(nm)

    n_inputs = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            val = node.meta["val"]
            nm = names[n_inputs] if n_inputs < len(names) else \
                f"t{next(counter)}"
            n_inputs += 1
            declare(nm, val.shape, _dt(val.dtype))
            g.inputs.append(nm)
            env[node] = g.tensor(nm)
        elif node.op == "get_attr":
            if node.target not in consts_by_target:
                val = getattr(gm, node.target).detach()
                consts_by_target[node.target] = \
                    T.lit(val.item()) if val.dim() == 0 else \
                    const(val.cpu().numpy().copy())
            env[node] = consts_by_target[node.target]
        elif node.op == "call_function":
            if node.target is operator.getitem:
                env[node] = env[node.args[0]][node.args[1]]
                continue
            try:
                outs = _lower(node, read, emit)
            except CaptureError as e:
                _on_unsupported(node, str(e))
                raise CaptureError(f"{e} (at {source_location(node)})") \
                    from None
            if outs is None:
                reason = "no lowering to the term vocabulary"
                _on_unsupported(node, reason)
                raise CaptureError(
                    f"aten op `{op_name(node)}` at {source_location(node)} "
                    f"has {reason}")
            if isinstance(outs, list):
                env[node] = [emit(t) for t in outs]
            else:
                val = node.meta["val"]
                assert outs.shape == tuple(val.shape), \
                    f"{tuple(val.shape)} vs {outs.shape} for {op_name(node)}"
                env[node] = emit(outs)
        elif node.op == "output":
            for out in _flat(node.args[0]):
                t = env[out]
                if t.op == "lit":
                    t = const(np.asarray(t.value))
                g.outputs.append(t.name)
        else:
            raise CaptureError(f"unexpected fx node kind {node.op}")
    return g


# ---------------------------------------------------------------------------
# Aten normalization
# ---------------------------------------------------------------------------

_EW1_MAP = {
    aten.neg.default: "neg", aten.exp.default: "exp", aten.log.default: "log",
    aten.tanh.default: "tanh", aten.sigmoid.default: "logistic",
    aten.rsqrt.default: "rsqrt", aten.sqrt.default: "sqrt",
    aten.sin.default: "sin", aten.cos.default: "cos",
    aten.abs.default: "abs", aten.erf.default: "erf",
    aten.floor.default: "floor", aten.sign.default: "sign",
    aten.log1p.default: "log1p", aten.expm1.default: "expm1",
    aten.logical_not.default: "not", aten.relu.default: "relu",
}
_IDENTITY = {aten.clone.default, aten.detach.default, aten.alias.default,
             aten.lift_fresh_copy.default}
_EW2_MAP = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.maximum.default: "max2", aten.minimum.default: "min2",
    aten.pow.Tensor_Tensor: "pow", aten.pow.Scalar: "pow",
    aten.eq.Tensor: "eq", aten.eq.Scalar: "eq",
    aten.ne.Tensor: "ne", aten.ne.Scalar: "ne",
    aten.lt.Tensor: "lt", aten.lt.Scalar: "lt",
    aten.le.Tensor: "le", aten.le.Scalar: "le",
    aten.gt.Tensor: "gt", aten.gt.Scalar: "gt",
    aten.ge.Tensor: "ge", aten.ge.Scalar: "ge",
    aten.logical_and.default: "and", aten.logical_or.default: "or",
    aten.remainder.Tensor: "rem", aten.remainder.Scalar: "rem",
    aten.atan2.default: "atan2",
    aten.bitwise_left_shift.Tensor: "shift_left",
    aten.bitwise_right_shift.Tensor: "shift_right",
}
_FILL = {aten.zeros.default: 0, aten.ones.default: 1,
         aten.zeros_like.default: 0, aten.ones_like.default: 1}
_REDUCE = {aten.sum.dim_IntList: "reduce_sum", aten.sum.default: "reduce_sum",
           aten.amax.default: "reduce_max", aten.amin.default: "reduce_min",
           aten.prod.dim_int: "reduce_prod", aten.prod.default: "reduce_prod",
           aten.all.dim: "reduce_and", aten.all.default: "reduce_and",
           aten.any.dim: "reduce_or", aten.any.default: "reduce_or"}
_SPMD = {f"{spmd.NAMESPACE}.{n}" for n in (
    "psum", "all_gather", "reduce_scatter", "all_to_all", "ppermute",
    "axis_index", "dynamic_slice", "dynamic_update_slice")}

# The aten (and SPMD shim) ops with a lowering: the port's counterpart of
# the JAX capture's primitive table.
SUPPORTED_PRIMITIVES = frozenset(
    {_target_name(t) for t in
     set(_EW1_MAP) | _IDENTITY | set(_EW2_MAP) | set(_FILL) | set(_REDUCE)}
    | {f"aten.{n}" for n in (
        "_to_copy", "where", "clamp", "mm", "bmm", "addmm", "view",
        "reshape", "_unsafe_view", "squeeze", "unsqueeze", "expand",
        "permute", "t", "transpose", "slice", "select", "cat", "split",
        "split_with_sizes", "constant_pad_nd", "mean", "cumsum", "argmax",
        "bitwise_and", "bitwise_or", "full", "full_like", "scalar_tensor",
        "arange", "embedding", "rsub")}
    | _SPMD)


def _lift(t: Term, shape) -> Term:
    """Broadcast a scalar or lower-rank operand to ``shape`` (numpy's
    right-aligned rule), so ew2 operands are shape-uniform."""
    shape = tuple(shape)
    if t.shape == shape or shape == ():
        return t
    if t.shape == ():
        return T.broadcast(t, shape, ())
    k = len(shape) - len(t.shape)
    if k < 0:
        raise AssertionError(f"cannot lift {t.shape} to {shape}")
    return T.broadcast(t, shape, tuple(range(k, len(shape))))


def _is_num(v) -> bool:
    return isinstance(v, (bool, int, float))


def _scalar(v, kind: str) -> Term:
    """A Python scalar operand as a literal of the promoted kind (jax's weak
    typing: ``x / 2`` on floats divides by ``2.0``)."""
    return T.lit(float(v) if kind == "f" else int(v))


def _operands(read, a, b):
    """Both operands of a binary op as Terms; a Python scalar takes the
    other operand's kind (float wins), and an int tensor meeting a float
    scalar is converted first, as jnp does."""
    if _is_num(a) and _is_num(b):
        raise CaptureError("binary op on two Python scalars")
    if _is_num(a) or _is_num(b):
        num, ten = (a, read(b)) if _is_num(a) else (b, read(a))
        kind = "f" if ten.dtype == "f" or isinstance(num, float) else "i"
        if ten.dtype != kind:
            ten = T.convert(ten, kind)
        lit = _scalar(num, kind)
        return (lit, ten) if _is_num(a) else (ten, lit)
    return read(a), read(b)


def _dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _out(node):
    val = node.meta["val"]
    return tuple(val.shape), _dt(val.dtype)


def _slice(x: Term, dim: int, start, end) -> Term:
    n = x.shape[dim]
    start = 0 if start is None else start
    end = n if end is None else end
    start, end = (min(max(v + n if v < 0 else v, 0), n) for v in (start, end))
    end = max(end, start)
    starts = tuple(start if i == dim else 0 for i in range(len(x.shape)))
    limits = tuple(end if i == dim else x.shape[i]
                   for i in range(len(x.shape)))
    return T.slice_(x, starts, limits)


def _reduce_axes(x: Term, dims) -> tuple:
    dims = [dims] if isinstance(dims, int) else dims
    if not dims:                   # None or []: every dim, as in aten
        return tuple(range(len(x.shape)))
    return tuple(sorted(_dim(d, len(x.shape)) for d in dims))


def _fill(value, shape, kind: str) -> Term:
    lit = _scalar(value, kind)
    return lit if shape == () else T.broadcast(lit, shape, ())


def _pad(x: Term, pad, value) -> Term:
    """``constant_pad_nd`` as concat with broadcast blocks, dim 0 first (the
    JAX capture's ``pad`` lowering). ``pad`` lists (lo, hi) from the last
    dim backwards."""
    rank = len(x.shape)
    cfg = [(0, 0)] * rank
    for i in range(len(pad) // 2):
        cfg[rank - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if any(lo < 0 or hi < 0 for lo, hi in cfg):
        raise CaptureError("negative padding unsupported")
    pv = _scalar(value, x.dtype)
    out = x
    for d, (lo, hi) in enumerate(cfg):
        pieces = []
        if lo:
            sh = tuple(lo if i == d else out.shape[i] for i in range(rank))
            pieces.append(T.broadcast(pv, sh, ()))
        pieces.append(out)
        if hi:
            sh = tuple(hi if i == d else out.shape[i] for i in range(rank))
            pieces.append(T.broadcast(pv, sh, ()))
        if len(pieces) > 1:
            out = T.concat(pieces, d)
    return out


def _lower(node, read, emit):
    """Output Term(s) for one call_function node (a list for multi-output
    ops), or None when the op has no lowering. ``emit`` defines an
    intermediate where jax emits two eqns for one aten op."""
    tgt = node.target
    a = node.args
    kw = node.kwargs
    shape, kind = _out(node) if "val" in node.meta and \
        isinstance(node.meta["val"], torch.Tensor) else (None, None)

    if tgt in _IDENTITY:
        return read(a[0])
    if tgt is aten._to_copy.default:
        x = read(a[0])
        return x if x.dtype == kind else T.convert(x, kind)
    if tgt in _EW1_MAP:
        return T.ew1(_EW1_MAP[tgt], read(a[0]))
    if tgt in _EW2_MAP:
        if kw.get("alpha", 1) != 1 or len(a) > 2:
            return None
        x, y = _operands(read, a[0], a[1])
        return T.ew2(_EW2_MAP[tgt], _lift(x, shape), _lift(y, shape))
    if tgt in (aten.bitwise_and.Tensor, aten.bitwise_or.Tensor) \
            and kind == "b":                    # `&`/`|` on bools
        op = "and" if tgt is aten.bitwise_and.Tensor else "or"
        return T.ew2(op, _lift(read(a[0]), shape), _lift(read(a[1]), shape))
    if tgt is aten.rsub.Scalar:                  # other - x
        if kw.get("alpha", 1) != 1 or len(a) > 2:
            return None
        x, y = _operands(read, a[1], a[0])
        return T.ew2("sub", _lift(x, shape), _lift(y, shape))
    if tgt is aten.pow.Tensor_Scalar:
        x, p = read(a[0]), a[1]
        if isinstance(p, int) and not isinstance(p, bool):
            return T.integer_pow(x, p)
        x, y = _operands(read, a[0], p)
        return T.ew2("pow", _lift(x, shape), _lift(y, shape))
    if tgt in (aten.where.self, aten.where.ScalarOther, aten.where.ScalarSelf,
               aten.where.Scalar):
        pred = read(a[0])
        on_t = _scalar(a[1], kind) if _is_num(a[1]) else read(a[1])
        on_f = _scalar(a[2], kind) if _is_num(a[2]) else read(a[2])
        return T.select(_lift(pred, shape), _lift(on_t, shape),
                        _lift(on_f, shape))
    if tgt is aten.clamp.default:
        out = read(a[0])
        lo = a[1] if len(a) > 1 else kw.get("min")
        hi = a[2] if len(a) > 2 else kw.get("max")
        if hi is not None:
            out = T.ew2("min2", _lift(out, shape), _lift(_scalar(hi, kind),
                                                         shape))
        if lo is not None:
            out = T.ew2("max2", _lift(out, shape), _lift(_scalar(lo, kind),
                                                         shape))
        return out
    if tgt is aten.mm.default:
        return T.matmul(read(a[0]), read(a[1]))
    if tgt is aten.bmm.default:
        return T.bmm(read(a[0]), read(a[1]))
    if tgt is aten.addmm.default:
        if kw.get("beta", 1) != 1 or kw.get("alpha", 1) != 1:
            return None
        mm = T.matmul(read(a[1]), read(a[2]))
        return T.ew2("add", _lift(read(a[0]), shape), mm)
    if tgt in (aten.view.default, aten.reshape.default,
               aten._unsafe_view.default, aten.squeeze.dim,
               aten.squeeze.dims, aten.squeeze.default):
        return T.reshape(read(a[0]), shape)
    if tgt is aten.unsqueeze.default:           # jnp's x[None]
        x = read(a[0])
        d = _dim(a[1], len(shape))
        return T.broadcast(x, shape, tuple(i for i in range(len(shape))
                                           if i != d))
    if tgt is aten.expand.default:
        return _lift(read(a[0]), shape)
    if tgt is aten.permute.default:
        x = read(a[0])
        return T.transpose(x, tuple(_dim(p, len(x.shape)) for p in a[1]))
    if tgt is aten.t.default:
        x = read(a[0])
        return T.transpose(x, (1, 0)) if len(x.shape) == 2 else x
    if tgt is aten.transpose.int:
        x = read(a[0])
        perm = list(range(len(x.shape)))
        d0, d1 = _dim(a[1], len(perm)), _dim(a[2], len(perm))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return T.transpose(x, tuple(perm))
    if tgt is aten.slice.Tensor:
        x = read(a[0])
        dim = _dim(a[1] if len(a) > 1 else 0, len(x.shape))
        start = a[2] if len(a) > 2 else None
        end = a[3] if len(a) > 3 else None
        step = a[4] if len(a) > 4 else 1
        if step != 1:
            return None
        return _slice(x, dim, start, end)
    if tgt is aten.select.int:                  # slice, then squeeze
        x = read(a[0])
        dim = _dim(a[1], len(x.shape))
        i = a[2] + x.shape[dim] if a[2] < 0 else a[2]
        return T.reshape(emit(_slice(x, dim, i, i + 1)), shape)
    if tgt is aten.cat.default:
        xs = [read(t) for t in a[0]]
        dim = a[1] if len(a) > 1 else kw.get("dim", 0)
        return T.concat(xs, _dim(dim, len(xs[0].shape)))
    if tgt in (aten.split.Tensor, aten.split_with_sizes.default):
        x = read(a[0])
        dim = _dim(a[2] if len(a) > 2 else kw.get("dim", 0), len(x.shape))
        n = x.shape[dim]
        sizes = [min(a[1], n - o) for o in range(0, n, a[1])] \
            if isinstance(a[1], int) else list(a[1])
        outs, off = [], 0
        for sz in sizes:
            outs.append(_slice(x, dim, off, off + sz))
            off += sz
        return outs
    if tgt is aten.constant_pad_nd.default:
        return _pad(read(a[0]), a[1], a[2] if len(a) > 2 else 0)
    if tgt in _REDUCE:
        x = read(a[0])
        if kw.get("dtype") is not None:
            return None
        dims = a[1] if len(a) > 1 else kw.get("dim")
        out = T.reduce_(_REDUCE[tgt], x, _reduce_axes(x, dims))
        return T.reshape(out, shape)            # keepdim
    if tgt is aten.mean.dim:
        x = read(a[0])
        if kw.get("dtype") is not None:
            return None
        axes = _reduce_axes(x, a[1] if len(a) > 1 else None)
        s = T.reduce_("reduce_sum", x, axes)
        n = int(np.prod([x.shape[i] for i in axes], dtype=np.int64))
        return T.reshape(T.ew2("div", s, _lift(T.lit(float(n)), s.shape)),
                         shape)
    if tgt is aten.cumsum.default:
        x = read(a[0])
        return T.cumsum(x, _dim(a[1], len(x.shape)))
    if tgt is aten.argmax.default:
        x = read(a[0])
        if len(a) < 2 or a[1] is None:
            return None
        return T.reshape(T.argmax(x, _dim(a[1], len(x.shape))), shape)
    if tgt in _FILL:
        return _fill(_FILL[tgt], shape, kind)
    if tgt in (aten.full.default, aten.full_like.default):
        return _fill(a[1], shape, kind)
    if tgt is aten.scalar_tensor.default:
        return _scalar(a[0], kind)
    if tgt in (aten.arange.default, aten.arange.start,
               aten.arange.start_step):
        nums = list(a) + [1] * (3 - len(a)) if tgt is not \
            aten.arange.default else [0, a[0], 1]
        if nums[0] != 0 or nums[2] != 1:
            return None
        return T.iota(shape, 0, kind)
    if tgt is aten.embedding.default:
        return T.gather_rows(read(a[0]), read(a[1]))
    if op_name(node) in _SPMD:
        return _lower_spmd(node, read, shape)
    return None


def _lower_spmd(node, read, shape):
    name = op_name(node).split(".")[-1]
    a = node.args
    if name == "axis_index":
        return Term("axis_index", (), (("axis", a[0]),), (), "i")
    x = read(a[0])
    if name == "psum":
        return Term("psum", (x,), (("axes", tuple(a[1].split(","))),),
                    x.shape, x.dtype)
    if name == "all_gather":
        return Term("all_gather", (x,),
                    (("axes", tuple(a[1].split(","))), ("dim", a[2]),
                     ("tiled", bool(a[3]))), shape, x.dtype)
    if name == "reduce_scatter":
        return Term("reduce_scatter", (x,),
                    (("axes", tuple(a[1].split(","))), ("dim", a[2])),
                    shape, x.dtype)
    if name == "all_to_all":
        return Term("all_to_all", (x,),
                    (("axes", tuple(a[1].split(","))), ("split", a[2]),
                     ("concat", a[3])), shape, x.dtype)
    if name == "ppermute":
        flat = list(a[2])
        perm = tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))
        return Term("ppermute", (x,), (("axis", a[1]), ("perm", perm)),
                    x.shape, x.dtype)
    if name == "dynamic_slice":
        starts = tuple(read(s) for s in a[1])
        sizes = tuple(a[2])
        if all(s.op == "lit" for s in starts):
            st = tuple(min(max(int(s.value), 0), d - z)
                       for s, d, z in zip(starts, x.shape, sizes))
            return T.slice_(x, st, tuple(s + z for s, z in zip(st, sizes)))
        return Term("dyn_slice", (x,) + starts, (("sizes", sizes),), sizes,
                    x.dtype)
    # dynamic_update_slice
    u = read(a[1])
    starts = tuple(read(s) for s in a[2])
    if all(s.op == "lit" for s in starts):
        st = tuple(min(max(int(s.value), 0), d - z)
                   for s, d, z in zip(starts, x.shape, u.shape))
        return T.dus(x, u, st)
    return Term("dyn_update_slice", (x, u) + starts, (), x.shape, x.dtype)


# ---------------------------------------------------------------------------
# SPMD expansion: per-rank instantiation + collective translation
# ---------------------------------------------------------------------------

def rank_tag(axis_names, coords) -> str:
    """Name suffix identifying one rank, e.g. ``@dp0,tp1``."""
    return "@" + ",".join(f"{a}{c}" for a, c in zip(axis_names, coords))


def expand_spmd(cap: SpmdCapture) -> tuple[Graph, dict]:
    """Expand the per-rank SPMD graph into a multi-rank Graph.

    Returns (expanded graph, input relation R_i) where R_i maps each logical
    (sequential) input name to a list of clean Terms over expanded input
    tensors — derived from the in_specs (§2.1: the distribution strategy's
    input relation; deriving it from the sharding spec is our extension).
    """
    g = cap.graph
    axis_names = tuple(cap.mesh_axes)
    sizes = tuple(cap.mesh_axes[a] for a in axis_names)
    all_coords = list(itertools.product(*[range(s) for s in sizes]))

    out = Graph([], [], [], {}, {}, {})

    def reg(name, shape, dtype):
        out.shapes[name] = shape
        out.dtypes[name] = dtype

    # per-rank inputs
    for name in g.inputs:
        for c in all_coords:
            nm = name + rank_tag(axis_names, c)
            reg(nm, g.shapes[name], g.dtypes[name])
            out.inputs.append(nm)
    # consts are rank-invariant: register once per rank (same value)
    for cname, val in g.consts.items():
        for c in all_coords:
            nm = cname + rank_tag(axis_names, c)
            out.consts[nm] = val
            reg(nm, tuple(val.shape), _dt(val.dtype))

    def group(coords, axes):
        """Rank-group of ``coords`` varying ``axes`` (ordered by coordinate)."""
        idxs = [axis_names.index(a) for a in axes]
        ranges = [range(sizes[i]) for i in idxs]
        members = []
        for combo in itertools.product(*ranges):
            c = list(coords)
            for i, v in zip(idxs, combo):
                c[i] = v
            members.append(tuple(c))
        return members

    # per-rank scalar-constant propagation: axis_index arithmetic becomes
    # literal per rank, letting dynamic slices fold to static slices.
    scalar_env: dict = {}
    for name, term in g.defs:
        for c in all_coords:
            tag = rank_tag(axis_names, c)
            inst = _instantiate(term, tag, c, axis_names, sizes, group, out,
                                scalar_env)
            nm = name + tag
            if inst.shape == ():
                v = _fold_scalar(inst)
                if v is not None:
                    scalar_env[nm] = v
                    inst = T.lit(v)
            reg(nm, inst.shape, inst.dtype)
            out.defs.append((nm, inst))

    for name in g.outputs:
        for c in all_coords:
            out.outputs.append(name + rank_tag(axis_names, c))

    r_i = derive_input_relation(g, cap.in_specs, axis_names, sizes, all_coords)
    return out, r_i


def _instantiate(term: Term, tag: str, coords, axis_names, sizes, group,
                 out_graph, scalar_env=None) -> Term:
    """Instantiate a per-rank term for a specific rank coordinate."""
    scalar_env = scalar_env or {}

    def go(t: Term) -> Term:
        if t.op == "tensor":
            nm = t.name + tag
            if nm in scalar_env:
                return T.lit(scalar_env[nm])
            return T.tensor(nm, t.shape, t.dtype)
        if t.op == "lit":
            return t
        if t.op == "axis_index":
            return T.lit(coords[axis_names.index(t.attr("axis"))])
        if t.op == "psum":
            members = group(coords, t.attr("axes"))
            return T.add_n(_retag(t.args[0], rank_tag(axis_names, m), m,
                                  axis_names, sizes, group)
                           for m in members)
        if t.op == "all_gather":
            gmembers = group(coords, t.attr("axes"))
            d, tiled = t.attr("dim"), t.attr("tiled")
            pieces = [_retag(t.args[0], rank_tag(axis_names, m), m,
                             axis_names, sizes, group) for m in gmembers]
            if tiled:
                return T.concat(pieces, d)
            pieces = [T.reshape(p, p.shape[:d] + (1,) + p.shape[d:])
                      for p in pieces]
            return T.concat(pieces, d) if len(pieces) > 1 else pieces[0]
        if t.op == "reduce_scatter":
            gmembers = group(coords, t.attr("axes"))
            d = t.attr("dim")
            pieces = [_retag(t.args[0], rank_tag(axis_names, m), m,
                             axis_names, sizes, group) for m in gmembers]
            s = T.add_n(pieces)
            k = gmembers.index(coords)
            blk = s.shape[d] // len(gmembers)
            starts = tuple(k * blk if i == d else 0 for i in range(len(s.shape)))
            limits = tuple((k + 1) * blk if i == d else s.shape[i]
                           for i in range(len(s.shape)))
            return T.slice_(s, starts, limits)
        if t.op == "all_to_all":
            gmembers = group(coords, t.attr("axes"))
            sa, ca = t.attr("split"), t.attr("concat")
            n = len(gmembers)
            k = gmembers.index(coords)
            pieces = []
            for m in gmembers:
                x = _retag(t.args[0], rank_tag(axis_names, m), m,
                           axis_names, sizes, group)
                blk = x.shape[sa] // n
                starts = tuple(k * blk if i == sa else 0
                               for i in range(len(x.shape)))
                limits = tuple((k + 1) * blk if i == sa else x.shape[i]
                               for i in range(len(x.shape)))
                pieces.append(T.slice_(x, starts, limits))
            return T.concat(pieces, ca)
        if t.op == "ppermute":
            perm = dict(t.attr("perm"))
            axis = t.attr("axis")
            ai = axis_names.index(axis)
            me = coords[ai]
            src = next((s for s, dst in perm.items() if dst == me), None)
            if src is None:
                return T.broadcast(T.lit(0.0 if t.dtype == "f" else 0),
                                   t.shape, ())
            sc = tuple(src if i == ai else coords[i]
                       for i in range(len(coords)))
            return _retag(t.args[0], rank_tag(axis_names, sc), sc,
                          axis_names, sizes, group)
        args = tuple(go(a) for a in t.args)
        if t.op in ("dyn_slice", "dyn_update_slice"):
            return _fold_dynamic(t, args)
        if t.op == "select":
            # rank-conditional writes (``jnp.where(axis_index(a) == k, ...)``)
            # fold per rank once axis_index is a literal: chase the predicate
            # through its broadcast and take the branch it selects
            pred = args[0]
            while pred.op == "broadcast":
                pred = pred.args[0]
            v = _fold_scalar(pred)
            if v is not None:
                return args[1] if v else args[2]
        return Term(t.op, args, t.attrs, t.shape, t.dtype)

    return go(term)


def _retag(term: Term, tag: str, coords, axis_names, sizes, group) -> Term:
    return _instantiate(term, tag, coords, axis_names, sizes, group, None)


def _fold_dynamic(t: Term, args) -> Term:
    """Fold dynamic slices whose start indices are now literal."""
    if t.op == "dyn_slice":
        x, starts = args[0], args[1:]
        vals = _fold_scalars(starts)
        if vals is None:
            return Term(t.op, args, t.attrs, t.shape, t.dtype)
        sizes = t.attr("sizes")
        st = tuple(min(max(v, 0), d - z)
                   for v, d, z in zip(vals, x.shape, sizes))
        return T.slice_(x, st, tuple(s + z for s, z in zip(st, sizes)))
    x, u, starts = args[0], args[1], args[2:]
    vals = _fold_scalars(starts)
    if vals is None:
        return Term(t.op, args, t.attrs, t.shape, t.dtype)
    st = tuple(min(max(v, 0), d - z)
               for v, d, z in zip(vals, x.shape, u.shape))
    return T.dus(x, u, st)


def _fold_scalars(ts) -> Optional[tuple]:
    out = []
    for t in ts:
        v = _fold_scalar(t)
        if v is None:
            return None
        out.append(int(v))
    return tuple(out)


def _fold_scalar(t: Term):
    """Constant-fold a scalar term (post axis_index substitution)."""
    if t.op == "lit":
        return t.value
    if t.shape != ():
        return None
    try:
        if any(l.op == "tensor" for l in t.leaves()):
            return None
        return T.eval_term(t, {}).item()
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Input relation derivation (from PartitionSpecs)
# ---------------------------------------------------------------------------

def derive_input_relation(g: Graph, in_specs, axis_names, sizes, all_coords):
    """R_i: logical input name -> [clean Terms over per-rank input names].

    A dim sharded over mesh axes (a, b, ...) splits major-to-minor; the
    global tensor is the nested concat of per-rank pieces. Unsharded mesh
    axes replicate: each replica yields its own mapping (paper: a relation
    may contain several mappings for one tensor)."""
    r_i: dict = {}
    for name, spec in zip(g.inputs, in_specs):
        local = tuple(g.shapes[name])  # inner-jaxpr shapes are per-shard
        dt = g.dtypes[name]
        spec = tuple(spec) if spec is not None else ()
        spec = spec + (None,) * (len(local) - len(spec))
        used = []
        for entry in spec:
            if entry is None:
                continue
            entries = entry if isinstance(entry, tuple) else (entry,)
            used.extend(entries)
        unused = [a for a in axis_names if a not in used]

        def build(rep_coords: dict) -> Term:
            """Nested concat over sharded axes for one replica assignment."""
            def rec(d: int, fixed: dict) -> Term:
                if d == len(spec):
                    coords = tuple(fixed.get(a, rep_coords.get(a, 0))
                                   for a in axis_names)
                    return T.tensor(name + rank_tag(axis_names, coords),
                                    local, dt)
                entry = spec[d]
                if entry is None:
                    return rec(d + 1, fixed)
                entries = entry if isinstance(entry, tuple) else (entry,)
                def split(ei: int, fixed2: dict) -> Term:
                    if ei == len(entries):
                        return rec(d + 1, fixed2)
                    a = entries[ei]
                    n = sizes[axis_names.index(a)]
                    return T.concat([split(ei + 1, {**fixed2, a: k})
                                     for k in range(n)], d)
                return split(0, fixed)
            return rec(0, {})

        maps = []
        if unused:
            for combo in itertools.product(*[range(sizes[axis_names.index(a)])
                                             for a in unused]):
                maps.append(build(dict(zip(unused, combo))))
        else:
            maps.append(build({}))
        r_i[name] = maps
    return r_i

"""Term IR for GraphGuard expressions.

Terms are immutable, hash-consed symbolic expressions over tensors. They are
the unit of exchange between the capture layer (aten graph -> Graph), the EGraph
(terms are interned as ENodes), relation inference (clean expressions are
Terms), and the numeric evaluator (certificates are executable).

Op vocabulary (normalized from aten ops by ``repro_torch.core.capture``):

  leaves      tensor(name)  lit(value)
  rearrange   concat(xs..., dim)  slice(x, starts, limits)  transpose(x, perm)
              reshape(x, shape)   broadcast(x, shape, bdims)  convert(x)
  compute     matmul(a, b)        bmm(a, b)          gather_rows(tab, idx)
              ew1 family: neg exp log tanh logistic rsqrt sqrt sin cos abs
                          erf relu floor sign square integer_pow(p) stop_grad
              ew2 family: add sub mul div max2 min2 pow eq lt gt and or
                          (add is n-ary: ``add_n`` builds the flattened
                           normal form; 2-ary adds are the legacy binary op)
              reduce_sum(x, axes) reduce_max(x, axes) reduce_min(x, axes)
              select(pred, on_true, on_false)  iota(shape, dim)
              dus(x, upd, starts)              cumsum(x, axis)
              argmax(x, axis)  one_hot-ish encodings come in via eq/iota
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Op sets
# ---------------------------------------------------------------------------

EW1_OPS = frozenset({
    "neg", "exp", "log", "tanh", "logistic", "rsqrt", "sqrt", "sin", "cos",
    "abs", "erf", "relu", "floor", "sign", "square", "stop_grad", "log1p",
    "expm1", "not",
})
EW2_OPS = frozenset({
    "add", "sub", "mul", "div", "max2", "min2", "pow", "eq", "ne", "lt", "le",
    "gt", "ge", "and", "or", "rem", "atan2", "shift_left", "shift_right",
    "nextafter",
})
REDUCE_OPS = frozenset({"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
                        "reduce_and", "reduce_or"})
REARRANGE_OPS = frozenset({"concat", "slice", "transpose", "reshape",
                           "broadcast", "convert", "rev"})

# Ops permitted inside a *clean* expression (paper S3.2): element rearrangement
# plus cross-rank reductions (sum). ``add`` is the expanded form of psum /
# gradient accumulation. Anything else (mul/div/matmul/...) in a mapping
# indicates the implementation requires real computation to reconstruct the
# sequential output => bug.
CLEAN_OPS = frozenset({"concat", "slice", "transpose", "reshape", "convert",
                       "add", "rev", "broadcast", "iota"})


# ---------------------------------------------------------------------------
# Term
# ---------------------------------------------------------------------------

_intern: dict = {}


class Term:
    """Immutable hash-consed symbolic expression node."""

    __slots__ = ("op", "args", "attrs", "shape", "dtype", "_hash",
                 "_leaves", "_clean", "_size", "_skey")

    def __new__(cls, op: str, args: tuple = (), attrs: tuple = (),
                shape: tuple = (), dtype: str = "f"):
        key = (op, args, attrs, shape, dtype)
        hit = _intern.get(key)
        if hit is not None:
            return hit
        self = super().__new__(cls)
        self.op = op
        self.args = args
        self.attrs = attrs
        self.shape = shape
        self.dtype = dtype
        self._hash = hash(key)
        self._leaves = None
        self._clean = None
        self._size = None
        self._skey = None
        _intern[key] = self
        return self

    def __init__(self, *a, **k):  # state set in __new__
        pass

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return self is other

    # -- convenience -------------------------------------------------------
    @property
    def is_leaf(self) -> bool:
        return self.op in ("tensor", "lit")

    @property
    def name(self) -> str:
        assert self.op == "tensor"
        return self.attrs[0][1]

    @property
    def value(self):
        assert self.op == "lit"
        return self.attrs[0][1]

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def size(self) -> int:
        """Number of operator nodes (leaves are free; DAG-memoized)."""
        if self._size is None:
            self._size = 0 if self.is_leaf else \
                1 + sum(a.size() for a in self.args)
        return self._size

    def sort_key(self):
        """Deterministic structural key (DAG-memoized): tuples compare op
        first, so mixed-op comparisons never reach heterogeneous attrs.
        Extraction uses this to break cost ties independent of e-node
        iteration order."""
        if self._skey is None:
            self._skey = (self.op, self.attrs,
                          tuple(a.sort_key() for a in self.args))
        return self._skey

    def leaves(self) -> list["Term"]:
        """Distinct leaf terms (DAG-memoized)."""
        if self._leaves is None:
            if self.is_leaf:
                self._leaves = (self,)
            else:
                seen, out = set(), []
                for a in self.args:
                    for l in a.leaves():
                        if l not in seen:
                            seen.add(l)
                            out.append(l)
                self._leaves = tuple(out)
        return list(self._leaves)

    def ops_used(self) -> set:
        if self.is_leaf:
            return set()
        out = {self.op}
        for a in self.args:
            out |= a.ops_used()
        return out

    def is_clean(self) -> bool:
        """All interior ops are clean rearrangement/reduction ops."""
        if self._clean is None:
            if self.is_leaf:
                self._clean = True
            elif self.op not in CLEAN_OPS:
                self._clean = False
            else:
                self._clean = all(a.is_clean() for a in self.args)
        return self._clean

    def __repr__(self):
        return pretty(self, max_depth=6)


def pretty(t: Term, max_depth: int = 99) -> str:
    """Render a Term as a readable expression, bounded by depth."""
    if t.op == "tensor":
        return t.name
    if t.op == "lit":
        v = t.value
        return f"{v:g}" if isinstance(v, float) else str(v)
    if max_depth == 0:
        return "..."
    inner = ", ".join(pretty(a, max_depth - 1) for a in t.args)
    extras = ", ".join(f"{k}={v}" for k, v in t.attrs)
    if extras:
        inner = f"{inner}, {extras}" if inner else extras
    return f"{t.op}({inner})"


# ---------------------------------------------------------------------------
# Constructors with shape inference
# ---------------------------------------------------------------------------

def tensor(name: str, shape: tuple, dtype: str = "f") -> Term:
    """Named tensor leaf."""
    return Term("tensor", (), (("name", name),), tuple(shape), dtype)


def lit(value) -> Term:
    """Scalar literal leaf (numpy scalars/bools normalized)."""
    if isinstance(value, (np.floating,)):
        value = float(value)
    if isinstance(value, (np.integer,)):
        value = int(value)
    if isinstance(value, bool):
        value = int(value)
    dt = "f" if isinstance(value, float) else "i"
    return Term("lit", (), (("value", value),), (), dt)


def ew1(op: str, x: Term) -> Term:
    """Unary elementwise op (shape/dtype preserved)."""
    assert op in EW1_OPS, op
    return Term(op, (x,), (), x.shape, x.dtype)


def integer_pow(x: Term, p: int) -> Term:
    """x ** p for integer literal p."""
    return Term("integer_pow", (x,), (("p", p),), x.shape, x.dtype)


def ew2(op: str, x: Term, y: Term) -> Term:
    """Binary elementwise op; scalars lift, comparisons yield bools."""
    assert op in EW2_OPS, op
    assert x.shape == y.shape or x.shape == () or y.shape == (), \
        f"ew2 {op} shape mismatch {x.shape} vs {y.shape}"
    shape = x.shape if x.shape else y.shape
    dt = "b" if op in ("eq", "ne", "lt", "le", "gt", "ge", "and", "or") else \
        (x.dtype if x.shape else y.dtype)
    return Term(op, (x, y), (), shape, dt)


def add(x: Term, y: Term) -> Term:
    """Binary add (see ``add_n`` for the engine normal form)."""
    return ew2("add", x, y)


def add_n(xs: Iterable[Term]) -> Term:
    """Flattened n-ary add — the engine's add normal form.

    ``add`` nodes carry *any* number of addends (>= 2); nested adds are
    flattened at construction so a psum over a 16-rank group is one 16-ary
    node instead of a depth-15 binary chain (whose assoc/comm saturation
    blew up the 2D-mesh and FSDP cases — see EXPERIMENTS.md).  A 2-ary add
    is exactly the old binary node, so existing certificates are unchanged.
    """
    flat: list = []
    stack = list(xs)[::-1]
    while stack:                    # flatten to fixpoint, preserving order
        x = stack.pop()
        if x.op == "add":
            stack.extend(reversed(x.args))
        else:
            flat.append(x)
    assert flat
    if len(flat) == 1:
        return flat[0]
    if len(flat) == 2:
        return ew2("add", flat[0], flat[1])
    shape: tuple = ()
    for x in flat:
        assert x.shape == shape or x.shape == () or shape == (), \
            f"add_n shape mismatch {x.shape} vs {shape}"
        shape = shape or x.shape
    dt = next((x.dtype for x in flat if x.shape), flat[0].dtype)
    return Term("add", tuple(flat), (), shape, dt)


def matmul(a: Term, b: Term) -> Term:
    """Generalized matmul: (..., k) x (k, n) -> (..., n) (np.dot-style)."""
    assert len(a.shape) >= 1 and len(b.shape) == 2 and a.shape[-1] == b.shape[0], \
        f"matmul {a.shape} x {b.shape}"
    return Term("matmul", (a, b), (), a.shape[:-1] + (b.shape[1],), a.dtype)


def bmm(a: Term, b: Term) -> Term:
    """Batched matmul: (..., m, k) x (..., k, n) with identical batch dims."""
    assert len(a.shape) >= 2 and a.shape[:-2] == b.shape[:-2] and \
        a.shape[-1] == b.shape[-2], f"bmm {a.shape} x {b.shape}"
    return Term("bmm", (a, b), (), a.shape[:-2] + (a.shape[-2], b.shape[-1]),
                a.dtype)


def concat(xs: Iterable[Term], dim: int) -> Term:
    """Concatenate along ``dim`` (singleton lists collapse)."""
    xs = tuple(xs)
    assert xs
    if len(xs) == 1:
        return xs[0]
    base = xs[0].shape
    for x in xs[1:]:
        assert len(x.shape) == len(base) and all(
            x.shape[i] == base[i] for i in range(len(base)) if i != dim), \
            f"concat mismatch {[x.shape for x in xs]} dim={dim}"
    shape = tuple(sum(x.shape[dim] for x in xs) if i == dim else base[i]
                  for i in range(len(base)))
    return Term("concat", xs, (("dim", dim),), shape, xs[0].dtype)


def slice_(x: Term, starts: tuple, limits: tuple) -> Term:
    """Contiguous slice [starts, limits); full slices collapse."""
    starts, limits = tuple(starts), tuple(limits)
    assert len(starts) == len(x.shape) == len(limits)
    for s, l, d in zip(starts, limits, x.shape):
        assert 0 <= s <= l <= d, f"slice oob {starts} {limits} of {x.shape}"
    shape = tuple(l - s for s, l in zip(starts, limits))
    if shape == x.shape:
        return x
    return Term("slice", (x,), (("starts", starts), ("limits", limits)),
                shape, x.dtype)


def transpose(x: Term, perm: tuple) -> Term:
    """Axis permutation; identity permutations collapse."""
    perm = tuple(perm)
    assert sorted(perm) == list(range(len(x.shape)))
    if perm == tuple(range(len(x.shape))):
        return x
    shape = tuple(x.shape[p] for p in perm)
    return Term("transpose", (x,), (("perm", perm),), shape, x.dtype)


def reshape(x: Term, shape: tuple) -> Term:
    """Reshape to ``shape`` (same element count); no-ops collapse."""
    shape = tuple(shape)
    assert int(np.prod(shape, dtype=np.int64)) == int(np.prod(x.shape, dtype=np.int64)), \
        f"reshape {x.shape} -> {shape}"
    if shape == x.shape:
        return x
    return Term("reshape", (x,), (("shape", shape),), shape, x.dtype)


def broadcast(x: Term, shape: tuple, bdims: tuple) -> Term:
    """broadcast_in_dim: x's axes map to positions ``bdims`` of ``shape``."""
    shape, bdims = tuple(shape), tuple(bdims)
    assert len(bdims) == len(x.shape)
    for xd, od in zip(x.shape, bdims):
        assert xd == shape[od] or xd == 1
    return Term("broadcast", (x,), (("shape", shape), ("bdims", bdims)),
                shape, x.dtype)


def convert(x: Term, dtype: str = "f") -> Term:
    """Dtype cast."""
    return Term("convert", (x,), (("to", dtype),), x.shape, dtype)


def rev(x: Term, dims: tuple) -> Term:
    """Reverse along ``dims``."""
    return Term("rev", (x,), (("dims", tuple(dims)),), x.shape, x.dtype)


def reduce_(op: str, x: Term, axes: tuple) -> Term:
    """Reduction over ``axes`` (sum/max/min/prod/and/or)."""
    axes = tuple(sorted(axes))
    assert op in REDUCE_OPS
    shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    return Term(op, (x,), (("axes", axes),), shape, x.dtype)


def reduce_sum(x: Term, axes: tuple) -> Term:
    """Sum reduction over ``axes``."""
    return reduce_("reduce_sum", x, axes)


def gather_rows(table: Term, idx: Term) -> Term:
    """Embedding lookup: table (V, D) indexed by integer idx (...,) -> (..., D)."""
    assert len(table.shape) == 2
    return Term("gather_rows", (table, idx), (),
                idx.shape + (table.shape[1],), table.dtype)


def select(pred: Term, on_true: Term, on_false: Term) -> Term:
    """Elementwise predicate select."""
    assert on_true.shape == on_false.shape
    return Term("select", (pred, on_true, on_false), (), on_true.shape,
                on_true.dtype)


def iota(shape: tuple, dim: int, dtype: str = "i") -> Term:
    """Index ramp along ``dim``."""
    return Term("iota", (), (("shape", tuple(shape)), ("dim", dim)),
                tuple(shape), dtype)


def dus(x: Term, upd: Term, starts: tuple) -> Term:
    """dynamic_update_slice: write ``upd`` into ``x`` at ``starts``."""
    return Term("dus", (x, upd), (("starts", tuple(starts)),), x.shape, x.dtype)


def cumsum(x: Term, axis: int) -> Term:
    """Cumulative sum along ``axis``."""
    return Term("cumsum", (x,), (("axis", axis),), x.shape, x.dtype)


def argmax(x: Term, axis: int) -> Term:
    """Integer argmax along ``axis`` (axis removed)."""
    shape = tuple(d for i, d in enumerate(x.shape) if i != axis)
    return Term("argmax", (x,), (("axis", axis),), shape, "i")


def opaque(name: str, args: tuple, shape: tuple, dtype: str = "f",
           attrs: tuple = ()) -> Term:
    """Uninterpreted operator (user kernels without lemmas)."""
    return Term(f"opaque:{name}", tuple(args), attrs, tuple(shape), dtype)


# ---------------------------------------------------------------------------
# Numeric evaluation (torch) — used by property tests and certificate replay
# ---------------------------------------------------------------------------
# Results follow numpy's dtype rules (the JAX package evaluates with numpy):
# each op's loop and output dtypes come from the numpy ufunc it mirrors, so
# a float32 tensor times a float64 literal is float64, an integer divide is
# float64, and ``convert`` to "f" gives float64, whichever device runs it.

_NP_OF = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.float16: np.float16,
          torch.float32: np.float32, torch.float64: np.float64}
_TORCH_OF = {np.dtype(v): k for k, v in _NP_OF.items()}


def _np_dtype(x: torch.Tensor) -> np.dtype:
    try:
        return np.dtype(_NP_OF[x.dtype])
    except KeyError:
        raise TypeError(f"eval_term has no numpy rule for {x.dtype}") from None


def _ufunc(ufunc, fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` computed in the loop dtypes numpy's ``ufunc`` resolves
    for these operands, returned in numpy's output dtype."""
    loop = ufunc.resolve_dtypes(tuple(_np_dtype(x) for x in xs) + (None,))
    out = fn(*(x.to(_TORCH_OF[d]) for x, d in zip(xs, loop)))
    return out.to(_TORCH_OF[loop[-1]])


def _erf(x: torch.Tensor) -> torch.Tensor:
    # numpy applies math.erf (double) elementwise; floats keep their dtype
    out = torch.erf(x.to(torch.float64))
    return out.to(x.dtype) if x.is_floating_point() else out


_EW1 = {
    "neg": (np.negative, torch.neg), "exp": (np.exp, torch.exp),
    "log": (np.log, torch.log), "tanh": (np.tanh, torch.tanh),
    "logistic": (np.exp, lambda x: 1 / (1 + torch.exp(-x))),
    "rsqrt": (np.sqrt, lambda x: 1 / torch.sqrt(x)),
    "sqrt": (np.sqrt, torch.sqrt), "sin": (np.sin, torch.sin),
    "cos": (np.cos, torch.cos), "abs": (np.absolute, torch.abs),
    "floor": (np.floor, torch.floor),
    "sign": (np.sign, torch.sign), "square": (np.square, torch.square),
    "log1p": (np.log1p, torch.log1p), "expm1": (np.expm1, torch.expm1),
    "not": (np.logical_not, torch.logical_not),
}

_EW2 = {
    "add": (np.add, torch.add), "sub": (np.subtract, torch.sub),
    "mul": (np.multiply, torch.mul), "div": (np.divide, torch.div),
    "max2": (np.maximum, torch.maximum), "min2": (np.minimum, torch.minimum),
    "pow": (np.power, torch.pow), "eq": (np.equal, torch.eq),
    "ne": (np.not_equal, torch.ne), "lt": (np.less, torch.lt),
    "le": (np.less_equal, torch.le), "gt": (np.greater, torch.gt),
    "ge": (np.greater_equal, torch.ge),
    "and": (np.logical_and, torch.logical_and),
    "or": (np.logical_or, torch.logical_or),
    "rem": (np.remainder, torch.remainder),
    "atan2": (np.arctan2, torch.atan2),
    "nextafter": (np.nextafter, torch.nextafter),
    "shift_left": (np.left_shift, torch.bitwise_left_shift),
    "shift_right": (np.right_shift, torch.bitwise_right_shift),
}


def _ew1(op: str, x: torch.Tensor) -> torch.Tensor:
    if op == "stop_grad":
        return x
    if op == "erf":
        return _erf(x)
    if op == "relu":               # np.maximum(x, 0): 0 is a weak scalar
        return torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    ufunc, fn = _EW1[op]
    return _ufunc(ufunc, fn, x)


def _ew2(op: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    ufunc, fn = _EW2[op]
    return _ufunc(ufunc, fn, x, y)


def _result_type(*xs: torch.Tensor) -> torch.dtype:
    return _TORCH_OF[np.result_type(*(_np_dtype(x) for x in xs))]


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """numpy's accumulator for sum/prod/cumsum: ints and bools widen to
    int64, floats keep their dtype."""
    return x.dtype if x.is_floating_point() else torch.int64


def _reduce(op: str, x: torch.Tensor, axes: tuple) -> torch.Tensor:
    if op in ("reduce_sum", "reduce_prod"):
        x = x.to(_sum_dtype(x))
    elif op in ("reduce_and", "reduce_or"):
        x = x.to(torch.bool)
    if not axes:                   # numpy reduces over no axis: identity
        return x
    if op == "reduce_sum":
        return torch.sum(x, dim=axes)
    if op == "reduce_max":
        return torch.amax(x, dim=axes)
    if op == "reduce_min":
        return torch.amin(x, dim=axes)
    fn = {"reduce_prod": torch.prod, "reduce_and": torch.all,
          "reduce_or": torch.any}[op]
    for a in sorted(axes, reverse=True):
        x = fn(x, dim=a)
    return x


def _device_of(env: dict, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def eval_term(t: Term, env: dict, device=None) -> torch.Tensor:
    """Evaluate a term against ``env: name -> tensor`` (numpy arrays are
    accepted and moved over). Literals, ramps and numpy values are made on
    ``device``, else on the device of the env's tensors, else the CPU."""
    dev = _device_of(env, device)
    memo: dict = {}

    def go(u: Term):
        if u in memo:
            return memo[u]
        r = _eval1(u, go, env, dev)
        memo[u] = r
        return r

    return go(t)


def _as_tensor(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    return torch.from_numpy(np.array(v)).to(dev)


def _eval1(u: Term, go, env, dev):
    op = u.op
    if op == "tensor":
        return _as_tensor(env[u.name], dev)
    if op == "lit":
        return torch.from_numpy(np.asarray(u.value)).to(dev)
    if op in EW1_OPS:
        return _ew1(op, go(u.args[0]))
    if op == "integer_pow":
        return torch.pow(go(u.args[0]), u.attr("p"))
    if op in EW2_OPS:
        if op == "add" and len(u.args) != 2:   # n-ary add normal form
            out = go(u.args[0])
            for a in u.args[1:]:
                out = _ew2("add", out, go(a))
            return out
        return _ew2(op, go(u.args[0]), go(u.args[1]))
    if op == "matmul" or op == "bmm":
        return _ufunc(np.matmul, torch.matmul, go(u.args[0]), go(u.args[1]))
    if op == "concat":
        xs = [go(a) for a in u.args]
        dt = _result_type(*xs)
        return torch.cat([x.to(dt) for x in xs], dim=u.attr("dim"))
    if op == "slice":
        starts, limits = u.attr("starts"), u.attr("limits")
        return go(u.args[0])[tuple(slice(s, l) for s, l in zip(starts, limits))]
    if op == "transpose":
        return go(u.args[0]).permute(u.attr("perm"))
    if op == "reshape":
        return go(u.args[0]).reshape(u.attr("shape"))
    if op == "broadcast":
        x, shape, bdims = go(u.args[0]), u.attr("shape"), u.attr("bdims")
        expanded = x.reshape(tuple(
            x.shape[bdims.index(i)] if i in bdims else 1
            for i in range(len(shape))))
        return expanded.expand(tuple(shape))
    if op == "convert":
        to = u.attr("to")
        return go(u.args[0]).to(torch.float64 if to == "f" else
                                torch.int64 if to == "i" else torch.bool)
    if op == "rev":
        return torch.flip(go(u.args[0]), tuple(u.attr("dims")))
    if op in REDUCE_OPS:
        return _reduce(op, go(u.args[0]), tuple(u.attr("axes")))
    if op == "gather_rows":
        return go(u.args[0])[go(u.args[1]).to(torch.int64)]
    if op == "select":
        a, b = go(u.args[1]), go(u.args[2])
        dt = _result_type(a, b)
        return torch.where(go(u.args[0]).to(torch.bool), a.to(dt), b.to(dt))
    if op == "iota":
        shape, dim = u.attr("shape"), u.attr("dim")
        out = torch.arange(shape[dim], dtype=torch.int64, device=dev)
        out = out.reshape(tuple(shape[dim] if i == dim else 1
                                for i in range(len(shape))))
        return out.expand(tuple(shape))
    if op == "dus":
        x = go(u.args[0]).clone()
        upd = go(u.args[1])
        starts = u.attr("starts")
        idx = tuple(slice(s, s + d) for s, d in zip(starts, upd.shape))
        x[idx] = upd
        return x
    if op == "cumsum":
        x = go(u.args[0])
        return torch.cumsum(x.to(_sum_dtype(x)), dim=u.attr("axis"))
    if op == "argmax":
        return torch.argmax(go(u.args[0]), dim=u.attr("axis"))
    raise NotImplementedError(f"eval of {op}")

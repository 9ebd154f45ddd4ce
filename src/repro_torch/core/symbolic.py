"""Symbolic scalar reasoning (paper §5.2 analogue).

The paper encodes symbolic shape/offset scalars in SMT-LIB and discharges
equality/inequality queries with an SMT solver. JAX shapes are static, so in
this framework symbolic scalars arise only from rank indices (``axis_index``)
and user-parameterized slice bounds. We implement the decidable fragment we
need — affine integer arithmetic — directly:

    AffExpr = c0 + sum_i c_i * var_i

Equality of affine expressions is decidable by canonicalization. Inequality
is decided when the difference is constant, or when user-supplied bounds
(var ranges) make the sign of the difference definite; otherwise we answer
``None`` ("unknown"), and the querying lemma simply does not fire — trading
completeness for soundness exactly like the paper's SMT timeout path.
"""
from __future__ import annotations

from typing import Optional, Union


class AffExpr:
    """Affine integer expression: const + sum(coef * var)."""

    __slots__ = ("const", "coefs")

    def __init__(self, const: int = 0, coefs: Optional[dict] = None):
        self.const = const
        self.coefs = {k: v for k, v in (coefs or {}).items() if v != 0}

    # -- constructors -------------------------------------------------------
    @staticmethod
    def var(name: str) -> "AffExpr":
        return AffExpr(0, {name: 1})

    @staticmethod
    def of(v: Union[int, "AffExpr"]) -> "AffExpr":
        return v if isinstance(v, AffExpr) else AffExpr(int(v))

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, o):
        o = AffExpr.of(o)
        coefs = dict(self.coefs)
        for k, v in o.coefs.items():
            coefs[k] = coefs.get(k, 0) + v
        return AffExpr(self.const + o.const, coefs)

    __radd__ = __add__

    def __neg__(self):
        return AffExpr(-self.const, {k: -v for k, v in self.coefs.items()})

    def __sub__(self, o):
        return self + (-AffExpr.of(o))

    def __rsub__(self, o):
        return AffExpr.of(o) - self

    def __mul__(self, o):
        if isinstance(o, AffExpr):
            if not o.coefs:
                o = o.const
            elif not self.coefs:
                return o * self.const
            else:
                raise NonAffine("product of two symbolic expressions")
        return AffExpr(self.const * o, {k: v * o for k, v in self.coefs.items()})

    __rmul__ = __mul__

    # -- status --------------------------------------------------------------
    @property
    def is_const(self) -> bool:
        return not self.coefs

    def as_int(self) -> int:
        if not self.is_const:
            raise NonAffine(f"not constant: {self}")
        return self.const

    def key(self):
        return (self.const, tuple(sorted(self.coefs.items())))

    def __eq__(self, o):
        if isinstance(o, (int, AffExpr)):
            return self.key() == AffExpr.of(o).key()
        return NotImplemented

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        parts = [str(self.const)] if self.const or not self.coefs else []
        parts += [f"{v}*{k}" if v != 1 else k
                  for k, v in sorted(self.coefs.items())]
        return " + ".join(parts)


class NonAffine(Exception):
    """An index expression fell outside the affine fragment the scalar
    solver can decide."""


class ScalarSolver:
    """Decides comparisons between affine expressions under var bounds."""

    def __init__(self):
        self.bounds: dict[str, tuple[Optional[int], Optional[int]]] = {}

    def assume_range(self, var: str, lo: Optional[int], hi: Optional[int]):
        self.bounds[var] = (lo, hi)

    def _range(self, e: AffExpr) -> tuple[Optional[int], Optional[int]]:
        lo = hi = e.const
        for k, c in e.coefs.items():
            blo, bhi = self.bounds.get(k, (None, None))
            if c >= 0:
                l, h = blo, bhi
            else:
                l, h = bhi, blo
            lo = None if (lo is None or l is None) else lo + c * l
            hi = None if (hi is None or h is None) else hi + c * h
        return lo, hi

    def eq(self, a, b) -> Optional[bool]:
        a, b = AffExpr.of(a), AffExpr.of(b)
        d = a - b
        if d.is_const:
            return d.const == 0
        lo, hi = self._range(d)
        if lo is not None and lo > 0:
            return False
        if hi is not None and hi < 0:
            return False
        return None  # unknown

    def le(self, a, b) -> Optional[bool]:
        d = AffExpr.of(b) - AffExpr.of(a)
        if d.is_const:
            return d.const >= 0
        lo, hi = self._range(d)
        if lo is not None and lo >= 0:
            return True
        if hi is not None and hi < 0:
            return False
        return None

    def lt(self, a, b) -> Optional[bool]:
        le = self.le(AffExpr.of(a) + 1, b)
        return le

"""GraphGuard lemma library (paper §4.2.1, §5).

Lemmas are procedural rewrite rules over the e-graph: each is triggered by an
e-node of a given op and returns equalities to install. The e-graph makes
rewrites bidirectional automatically (both sides land in one e-class).

The library covers the normalized op set (see ``terms.py``); it plays
the role of the paper's 92 ATen lemmas — normalization at capture time means
far fewer rules cover the same models. Lemma *sources* mirror the paper's
provenance split: ``taso`` marks rules ported from the TASO/Tensat families
(block matmul, transpose algebra), ``builtin`` marks rules we derived from
operator semantics, and user lemmas can be registered with
``register_lemma`` (evaluated in §6.5-analogue benchmark).

Constrained lemmas (paper §4.3.2) only fire when their expansive target
already exists in the e-graph — see ``lemma_slice_cover``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .egraph import EGraph, ENode, Lemma
from .terms import (EW1_OPS, EW2_OPS, REDUCE_OPS, Term, add_n, bmm, broadcast,
                    concat, convert, dus, ew1, ew2, gather_rows, integer_pow,
                    lit, matmul, reduce_, reshape, select, slice_, transpose)

# Widest n-ary add the normal form maintains: a 16-rank multi-axis psum is a
# 16-ary node; flattening stops growing chains past this (soundness is
# unaffected — only joinability of absurdly wide chains).
MAX_ADD_WIDTH = 64


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cls(eg: EGraph, cid: int) -> Term:
    """Build a leaf Term referring to e-class ``cid``."""
    info = eg.info(cid)
    return Term("cls", (), (("id", eg.find(cid)),), info.shape, info.dtype)


def concat_reps(eg: EGraph, cid: int):
    """All concat representations of a class: [(dim, [child cids])]."""
    out = []
    for n in eg.nodes_of(cid, "concat"):
        out.append((dict(n.attrs)["dim"], list(n.children)))
    return out


def slice_reps(eg: EGraph, cid: int):
    """All slice representations of a class: [(base cid, starts, limits)]."""
    out = []
    for n in eg.nodes_of(cid, "slice"):
        a = dict(n.attrs)
        out.append((n.children[0], a["starts"], a["limits"]))
    return out


def broadcast_reps(eg: EGraph, cid: int):
    """All broadcast representations of a class: [(src, shape, bdims)]."""
    out = []
    for n in eg.nodes_of(cid, "broadcast"):
        a = dict(n.attrs)
        out.append((n.children[0], a["shape"], a["bdims"]))
    return out


def _piece_terms(eg, cids):
    return [cls(eg, c) for c in cids]


def _rebuild_unary(node: ENode, arg: Term) -> Term:
    """Re-apply a unary-ish op (possibly with attrs) to a new argument."""
    op = node.op
    if op in EW1_OPS:
        return ew1(op, arg)
    if op == "integer_pow":
        return integer_pow(arg, dict(node.attrs)["p"])
    if op == "convert":
        return convert(arg, dict(node.attrs)["to"])
    raise AssertionError(op)


MAX_FANOUT = 16  # do not build rewrites over absurdly wide concats


# ---------------------------------------------------------------------------
# matmul / bmm block lemmas  [TASO/Tensat family]
# ---------------------------------------------------------------------------

def _matmul_block(eg: EGraph, node: ENode, cid: int):
    """Generalized matmul (..., k) x (k, n): k-split pairs with rhs row
    split; any other lhs-dim split distributes; rhs col split distributes."""
    ca, cb = node.children
    eqs = []
    a_sh = eg.info(ca).shape
    kdim = len(a_sh) - 1
    for dim, xs in concat_reps(eg, ca):
        if len(xs) > MAX_FANOUT:
            continue
        if dim == kdim:  # k split: need matching split of b on dim 0
            sizes = [eg.info(x).shape[kdim] for x in xs]
            for bdim, ys in concat_reps(eg, cb):
                if bdim != 0 or len(ys) != len(xs):
                    continue
                if [eg.info(y).shape[0] for y in ys] != sizes:
                    continue
                eqs.append((cid, add_n(matmul(cls(eg, x), cls(eg, y))
                                       for x, y in zip(xs, ys))))
        else:  # free-dim split
            eqs.append((cid, concat([matmul(cls(eg, x), cls(eg, cb))
                                     for x in xs], dim)))
    for dim, ys in concat_reps(eg, cb):
        if dim == 1 and len(ys) <= MAX_FANOUT:  # n split
            eqs.append((cid, concat([matmul(cls(eg, ca), cls(eg, y))
                                     for y in ys], kdim)))
    return eqs


def _bmm_block(eg: EGraph, node: ENode, cid: int):
    ca, cb = node.children
    a_sh = eg.info(ca).shape
    nd = len(a_sh)
    k_a, m_a = nd - 1, nd - 2
    eqs = []
    for dim, xs in concat_reps(eg, ca):
        if len(xs) > MAX_FANOUT:
            continue
        if dim == k_a:  # contraction split
            sizes = [eg.info(x).shape[k_a] for x in xs]
            for bdim, ys in concat_reps(eg, cb):
                if bdim != nd - 2 or len(ys) != len(xs):
                    continue
                if [eg.info(y).shape[nd - 2] for y in ys] != sizes:
                    continue
                eqs.append((cid, add_n(bmm(cls(eg, x), cls(eg, y))
                                       for x, y in zip(xs, ys))))
        elif dim == m_a:  # rows split
            eqs.append((cid, concat([bmm(cls(eg, x), cls(eg, cb))
                                     for x in xs], m_a)))
        else:  # batch split: need same split on b
            sizes = [eg.info(x).shape[dim] for x in xs]
            for bdim, ys in concat_reps(eg, cb):
                if bdim != dim or len(ys) != len(xs):
                    continue
                if [eg.info(y).shape[dim] for y in ys] != sizes:
                    continue
                eqs.append((cid, concat([bmm(cls(eg, x), cls(eg, y))
                                         for x, y in zip(xs, ys)], dim)))
    for dim, ys in concat_reps(eg, cb):
        if dim == nd - 1 and len(ys) <= MAX_FANOUT:  # cols split
            eqs.append((cid, concat([bmm(cls(eg, ca), cls(eg, y))
                                     for y in ys], nd - 1)))
    return eqs


# ---------------------------------------------------------------------------
# elementwise distribution over concat / broadcast
# ---------------------------------------------------------------------------

def _ew1_concat(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    eqs = []
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT:
            continue
        eqs.append((cid, concat([_rebuild_unary(node, cls(eg, x))
                                 for x in xs], dim)))
    return eqs


def _bcast_piece(eg: EGraph, cw: int, full_shape, bdims, piece_shape, dim) -> Optional[Term]:
    """broadcast(w) restricted to a concat piece along ``dim`` — valid iff the
    broadcast is constant along ``dim`` (source axis absent or extent 1)."""
    w_info = eg.info(cw)
    if dim in bdims:
        src_ext = w_info.shape[bdims.index(dim)]
        if src_ext != 1:
            return None
    return broadcast(cls(eg, cw), piece_shape, bdims)


def _addn_concat(eg: EGraph, node: ENode, cid: int):
    """n-ary add distributes over concat: every addend must decompose as a
    matching concat on one dim (same piece sizes), or be a broadcast
    constant along it."""
    chs = node.children
    if len(chs) > MAX_ADD_WIDTH:
        return []
    eqs = []
    seen = set()
    for anchor in chs:
        for dim, xs in concat_reps(eg, anchor):
            if len(xs) > MAX_FANOUT:
                continue
            sizes = tuple(eg.info(x).shape[dim] for x in xs)
            if (dim, sizes) in seen:
                continue
            seen.add((dim, sizes))
            cols = []
            ok = True
            for ch in chs:
                col = None
                for d2, ys in concat_reps(eg, ch):
                    if d2 == dim and len(ys) == len(xs) and \
                            tuple(eg.info(y).shape[dim] for y in ys) == sizes:
                        col = [cls(eg, y) for y in ys]
                        break
                if col is None:
                    for cw, shape, bdims in broadcast_reps(eg, ch):
                        pieces = [_bcast_piece(eg, cw, shape, bdims,
                                               eg.info(x).shape, dim)
                                  for x in xs]
                        if all(p is not None for p in pieces):
                            col = pieces
                            break
                if col is None:
                    ok = False
                    break
                cols.append(col)
            if ok:
                eqs.append((cid, concat([add_n([col[i] for col in cols])
                                         for i in range(len(xs))], dim)))
    return eqs


def _ew2_concat(eg: EGraph, node: ENode, cid: int):
    op = node.op
    if op == "add" and len(node.children) != 2:   # n-ary add normal form
        return _addn_concat(eg, node, cid)
    ca, cb = node.children
    sh_a, sh_b = eg.info(ca).shape, eg.info(cb).shape
    if sh_a != sh_b:
        return []  # scalar-lifting handled by capture normalization
    eqs = []
    for dim, xs in concat_reps(eg, ca):
        if len(xs) > MAX_FANOUT:
            continue
        sizes = [eg.info(x).shape[dim] for x in xs]
        # (1) matching concat on b
        for bdim, ys in concat_reps(eg, cb):
            if bdim != dim or len(ys) != len(xs):
                continue
            if [eg.info(y).shape[dim] for y in ys] != sizes:
                continue
            eqs.append((cid, concat([ew2(op, cls(eg, x), cls(eg, y))
                                     for x, y in zip(xs, ys)], dim)))
        # (2) b is a broadcast constant along dim
        for cw, shape, bdims in broadcast_reps(eg, cb):
            pieces = []
            ok = True
            for x in xs:
                p = _bcast_piece(eg, cw, shape, bdims, eg.info(x).shape, dim)
                if p is None:
                    ok = False
                    break
                pieces.append(ew2(op, cls(eg, x), p))
            if ok:
                eqs.append((cid, concat(pieces, dim)))
    # symmetric: concat on b, broadcast on a
    for dim, ys in concat_reps(eg, cb):
        if len(ys) > MAX_FANOUT:
            continue
        for cw, shape, bdims in broadcast_reps(eg, ca):
            pieces = []
            ok = True
            for y in ys:
                p = _bcast_piece(eg, cw, shape, bdims, eg.info(y).shape, dim)
                if p is None:
                    ok = False
                    break
                pieces.append(ew2(op, p, cls(eg, y)))
            if ok:
                eqs.append((cid, concat(pieces, dim)))
    return eqs


def _select_concat(eg: EGraph, node: ENode, cid: int):
    cp, ct, cf = node.children
    eqs = []
    for dim, ts in concat_reps(eg, ct):
        if len(ts) > MAX_FANOUT:
            continue
        sizes = [eg.info(t).shape[dim] for t in ts]
        for fdim, fs in concat_reps(eg, cf):
            if fdim != dim or [eg.info(f).shape[dim] for f in fs] != sizes:
                continue
            # pred: matching concat, or broadcast constant along dim
            for pdim, ps in concat_reps(eg, cp):
                if pdim != dim or [eg.info(p).shape[dim] for p in ps] != sizes:
                    continue
                eqs.append((cid, concat(
                    [select(cls(eg, p), cls(eg, t), cls(eg, f))
                     for p, t, f in zip(ps, ts, fs)], dim)))
            for cw, shape, bdims in broadcast_reps(eg, cp):
                pieces = []
                ok = True
                for t, f in zip(ts, fs):
                    p = _bcast_piece(eg, cw, shape, bdims, eg.info(t).shape, dim)
                    if p is None:
                        ok = False
                        break
                    pieces.append(select(p, cls(eg, t), cls(eg, f)))
                if ok:
                    eqs.append((cid, concat(pieces, dim)))
    return eqs


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_concat(eg: EGraph, node: ENode, cid: int):
    op = node.op
    (cx,) = node.children
    axes = dict(node.attrs)["axes"]
    eqs = []
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT:
            continue
        if dim in axes:
            pieces = [reduce_(op, cls(eg, x), axes) for x in xs]
            if op == "reduce_sum":
                eqs.append((cid, add_n(pieces)))
            elif op == "reduce_max":
                t = pieces[0]
                for p in pieces[1:]:
                    t = ew2("max2", t, p)
                eqs.append((cid, t))
            elif op == "reduce_min":
                t = pieces[0]
                for p in pieces[1:]:
                    t = ew2("min2", t, p)
                eqs.append((cid, t))
        else:
            nd = dim - sum(1 for a in axes if a < dim)
            eqs.append((cid, concat([reduce_(op, cls(eg, x), axes)
                                     for x in xs], nd)))
    return eqs


def _reduce_trivial(eg: EGraph, node: ENode, cid: int):
    """Reducing axes of extent 1 is a reshape."""
    (cx,) = node.children
    axes = dict(node.attrs)["axes"]
    in_shape = eg.info(cx).shape
    if not all(in_shape[a] == 1 for a in axes):
        return []
    out_shape = tuple(d for i, d in enumerate(in_shape) if i not in axes)
    return [(cid, reshape(cls(eg, cx), out_shape))]


def _reduce_broadcast(eg: EGraph, node: ENode, cid: int):
    """reduce_sum over an axis where the input is broadcast-constant equals
    extent * value — NOT clean, but exposes scaling relationships (used in
    diagnostics for the aux-loss / grad-accum bug families)."""
    if node.op != "reduce_sum":
        return []
    (cx,) = node.children
    axes = dict(node.attrs)["axes"]
    eqs = []
    for cw, shape, bdims in broadcast_reps(eg, cx):
        if not all((a not in bdims) or eg.info(cw).shape[bdims.index(a)] == 1
                   for a in axes):
            continue
        scale = int(np.prod([shape[a] for a in axes], dtype=np.int64))
        w_info = eg.info(cw)
        kept = [i for i in range(len(shape)) if i not in axes]
        new_bdims = tuple(kept.index(b) for b in bdims if b in kept)
        inner_axes = tuple(i for i, b in enumerate(bdims) if b in axes)
        src = cls(eg, cw)
        if inner_axes:
            src = reduce_("reduce_sum", src, inner_axes)
            new_bdims = tuple(kept.index(b) for b in bdims if b not in axes)
        out_shape = tuple(shape[i] for i in kept)
        rhs = ew2("mul", broadcast(src, out_shape, new_bdims),
                  broadcast(lit(float(scale)), out_shape, ()))
        eqs.append((cid, rhs))
    return eqs


# ---------------------------------------------------------------------------
# slice / concat algebra
# ---------------------------------------------------------------------------

def _slice_of_concat(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    a = dict(node.attrs)
    starts, limits = a["starts"], a["limits"]
    eqs = []
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT:
            continue
        s, l = starts[dim], limits[dim]
        off = 0
        pieces = []
        ok = True
        for x in xs:
            ext = eg.info(x).shape[dim]
            lo, hi = max(s - off, 0), min(l - off, ext)
            if lo < hi:
                ps = tuple(lo if i == dim else starts[i]
                           for i in range(len(starts)))
                pl = tuple(hi if i == dim else limits[i]
                           for i in range(len(limits)))
                try:
                    pieces.append(slice_(cls(eg, x), ps, pl))
                except AssertionError:
                    ok = False
                    break
            off += ext
        if ok and pieces:
            eqs.append((cid, concat(pieces, dim) if len(pieces) > 1 else pieces[0]))
    return eqs


def _slice_of_slice(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    a = dict(node.attrs)
    starts, limits = a["starts"], a["limits"]
    eqs = []
    for base, bs, bl in slice_reps(eg, cx):
        ns = tuple(b + s for b, s in zip(bs, starts))
        nl = tuple(b + l for b, l in zip(bs, limits))
        eqs.append((cid, slice_(cls(eg, base), ns, nl)))
    return eqs


def _slice_of_ew(eg: EGraph, node: ENode, cid: int):
    """slice(f(x)) = f(slice(x)) for elementwise f — constrained: only fires
    if slice(x) with the same bounds already exists (avoids blowup)."""
    (cx,) = node.children
    a = dict(node.attrs)
    starts, limits = a["starts"], a["limits"]
    eqs = []
    for n in eg.nodes_of(cx):
        if n.op in EW1_OPS or n.op in ("integer_pow", "convert"):
            inner = n.children[0]
            probe = ENode("slice", (("starts", starts), ("limits", limits)),
                          (eg.find(inner),))
            if probe in eg.hashcons:  # constrained
                sub = cls(eg, eg.hashcons[probe])
                eqs.append((cid, _rebuild_unary(n, sub)))
        elif n.op in EW2_OPS:
            probes = [ENode("slice", (("starts", starts), ("limits", limits)),
                            (eg.find(c),)) for c in n.children]
            if all(p in eg.hashcons for p in probes):
                args = [cls(eg, eg.hashcons[p]) for p in probes]
                if len(args) == 2:
                    eqs.append((cid, ew2(n.op, args[0], args[1])))
                elif n.op == "add":            # n-ary add normal form
                    eqs.append((cid, add_n(args)))
    return eqs


def _concat_merge(eg: EGraph, node: ENode, cid: int):
    """concat of adjacent slices of the same base -> merged slice; also
    flatten nested concats on the same dim."""
    dim = dict(node.attrs)["dim"]
    eqs = []
    # flatten nested concat
    flat = []
    changed = False
    for ch in node.children:
        sub = None
        for n2 in eg.nodes_of(ch, "concat"):
            if dict(n2.attrs)["dim"] == dim:
                sub = n2
                break
        if sub is not None:
            flat.extend(sub.children)
            changed = True
        else:
            flat.append(ch)
    if changed and len(flat) <= 2 * MAX_FANOUT:
        eqs.append((cid, concat([cls(eg, c) for c in flat], dim)))
    # adjacent slice merge (pairwise; saturation composes)
    chs = node.children
    for i in range(len(chs) - 1):
        for b1, s1, l1 in slice_reps(eg, chs[i]):
            for b2, s2, l2 in slice_reps(eg, chs[i + 1]):
                if eg.find(b1) != eg.find(b2):
                    continue
                if l1[dim] != s2[dim]:
                    continue
                if any(k != dim and (s1[k] != s2[k] or l1[k] != l2[k])
                       for k in range(len(s1))):
                    continue
                merged = slice_(cls(eg, b1),
                                s1, tuple(l2[k] if k == dim else l1[k]
                                          for k in range(len(l1))))
                rest = ([cls(eg, c) for c in chs[:i]] + [merged]
                        + [cls(eg, c) for c in chs[i + 2:]])
                eqs.append((cid, concat(rest, dim) if len(rest) > 1 else rest[0]))
    return eqs


def _concat_exchange(eg: EGraph, node: ENode, cid: int):
    """Block-matrix concat transposition: concat_d(A, B, ...) where every
    child decomposes as a concat on a common dim d2 != d with the *same*
    piece sizes along d2 equals concat_d2 of the per-piece concat_d's:

        concat_1(concat_0(A1, A2), concat_0(B1, B2))
          = concat_0(concat_1(A1, B1), concat_1(A2, B2))

    This is what connects per-rank outputs assembled along one axis with a
    rank split along another (e.g. rotary halves concatenated on features
    under a sequence-parallel rank split)."""
    dim = dict(node.attrs)["dim"]
    chs = node.children
    if len(chs) > MAX_FANOUT:
        return []
    eqs = []
    for d2, xs in concat_reps(eg, chs[0]):
        if d2 == dim or len(xs) > MAX_FANOUT:
            continue
        sizes = [eg.info(x).shape[d2] for x in xs]
        cols = [xs]
        ok = True
        for ch in chs[1:]:
            match = None
            for dd, ys in concat_reps(eg, ch):
                if dd == d2 and len(ys) == len(xs) and \
                        [eg.info(y).shape[d2] for y in ys] == sizes:
                    match = ys
                    break
            if match is None:
                ok = False
                break
            cols.append(match)
        if not ok:
            continue
        rows = [concat([cls(eg, col[i]) for col in cols], dim)
                for i in range(len(xs))]
        eqs.append((cid, concat(rows, d2)))
    return eqs


def _concat_inject(eg: EGraph, node: ENode, cid: int):
    """Concat is injective given the split sizes: two concat representations
    of one class on the same dim with identical piece-size lists have equal
    corresponding pieces.  This is the shard-replica equality a multi-axis
    mesh needs: an input sharded on `dp` and replicated on `tp` yields one
    concat mapping per tp-replica, and only piece-wise equality connects
    rank (i, 0)'s shard with rank (i, 1)'s."""
    dim = dict(node.attrs)["dim"]
    chs = node.children
    if len(chs) > MAX_FANOUT:
        return []
    sizes = [eg.info(c).shape[dim] for c in chs]
    eqs = []
    for d2, ys in concat_reps(eg, cid):
        if d2 != dim or len(ys) != len(chs):
            continue
        if [eg.info(y).shape[dim] for y in ys] != sizes:
            continue
        for a, b in zip(chs, ys):
            if eg.find(a) != eg.find(b):
                eqs.append((a, cls(eg, b)))
    return eqs


def _reduce_add(eg: EGraph, node: ENode, cid: int):
    """reduce_sum distributes over add — CONSTRAINED (paper §4.3.2): only
    fires when both per-addend reductions already exist as e-nodes.  This is
    the reduce/psum exchange a composed 2D mesh needs: it relates the
    sequential ``sum(y)`` through ``y = psum_tp(yp)`` to the per-rank
    ``psum_{dp,tp}(sum(yp))`` without generatively splitting every sum."""
    (cx,) = node.children
    axes = dict(node.attrs)["axes"]
    eqs = []
    for n2 in eg.nodes_of(cx, "add"):
        chs = n2.children                   # n-ary add normal form
        probes = [ENode("reduce_sum", (("axes", axes),), (eg.find(c),))
                  for c in chs]
        hits = [p in eg.hashcons for p in probes]
        if not any(hits):
            continue
        # at least one addend's reduction must pre-exist; the rest may be
        # built, so one fire resolves the whole (flattened) psum chain
        terms = [cls(eg, eg.hashcons[p]) if h
                 else reduce_("reduce_sum", cls(eg, c), axes)
                 for c, p, h in zip(chs, probes, hits)]
        eqs.append((cid, add_n(terms)))
    return eqs


def _reduce_reshape(eg: EGraph, node: ENode, cid: int):
    """Reduction across a reshape boundary: when the reduced axes of
    ``reduce(reshape(x, s'), axes)`` cover *complete* segments of the
    reshape's greedy factorization (see ``_segments``), the reduction
    commutes with the reshape —

        reduce_sum(reshape(x, (-1,)), (0,)) = reduce_sum(x, (0, 1))

    This is the aux-loss pattern: G_s sums a flattened view while G_d
    reduces both axes of the local shard at once (EXPERIMENTS.md used to
    carry it as a documented completeness gap)."""
    op = node.op
    (cx,) = node.children
    axes = set(dict(node.attrs)["axes"])
    new_shape = eg.info(cx).shape
    eqs = []
    for n2 in eg.nodes_of(cx, "reshape"):
        cb = n2.children[0]
        old_shape = eg.info(cb).shape
        segs = _segments(old_shape, new_shape)
        if segs is None:
            continue
        base_axes, ok = [], True
        for old_axes, new_axes in segs:
            hit = [a for a in new_axes if a in axes]
            if not hit:
                continue
            if len(hit) != len(new_axes):  # partially-reduced segment
                ok = False
                break
            base_axes.extend(old_axes)
        if not ok or not base_axes:
            continue
        inner = reduce_(op, cls(eg, cb), tuple(sorted(base_axes)))
        out_shape = tuple(d for i, d in enumerate(new_shape) if i not in axes)
        eqs.append((cid, inner if inner.shape == out_shape
                    else reshape(inner, out_shape)))
    return eqs


def _scalar_factor(eg: EGraph, node: ENode, cid: int):
    """Constant scalar factors distribute over ``add`` (and therefore over a
    psum's expanded cross-rank add chain):

        div(add(a, b), c) = add(div(a, c), div(b, c))
        mul(add(a, b), c) = add(mul(a, c), mul(b, c))

    for a literal (or broadcast-literal) ``c`` — the converse direction of
    ``add_div_dist``, triggered on the mul/div side so a sequential
    ``psum(x) / n`` can chase the per-rank ``x / n`` pieces.

    CONSTRAINED (paper §4.3.2): at least one addend's scaled node must
    already exist in the e-graph; the rest may be built, so one fire
    resolves the whole flattened n-ary add instead of generatively scaling
    every add in sight (unconstrained, it blows up the 8-rank chains)."""
    op = node.op
    ca, cb = node.children
    eqs = []
    for left, right in ((ca, cb), (cb, ca)):
        v = _lit_of(eg, right)
        if v is None or v == 0:
            continue
        if op == "div" and left is not ca:
            continue                     # only x/c distributes, not c/x
        cr = eg.find(right)
        for n2 in eg.nodes_of(left, "add"):
            chs = n2.children            # n-ary add normal form
            hits = []
            for ch in chs:
                hit = None
                for order in (((eg.find(ch), cr)), ((cr, eg.find(ch)))):
                    pn = ENode(op, (), order)
                    if pn in eg.hashcons:
                        hit = eg.hashcons[pn]
                        break
                    if op == "div":      # div is not commutative
                        break
                hits.append(hit)
            if all(h is None for h in hits):
                continue
            terms = [cls(eg, h) if h is not None
                     else ew2(op, cls(eg, ch), cls(eg, right))
                     for ch, h in zip(chs, hits)]
            eqs.append((cid, add_n(terms)))
    return eqs


def _slice_cover(eg: EGraph, node: ENode, cid: int):
    """CONSTRAINED lemma (paper §4.3.2): X = concat(X[0:a], X[a:b], ...) only
    when complementary slices already exist as e-nodes. Triggered on slice."""
    (cx,) = node.children
    a = dict(node.attrs)
    starts, limits = a["starts"], a["limits"]
    base_info = eg.info(cx)
    nd = len(base_info.shape)
    dims = [i for i in range(nd)
            if not (starts[i] == 0 and limits[i] == base_info.shape[i])]
    if len(dims) != 1:
        return []
    d = dims[0]
    # collect sibling slices of cx along d with other dims full
    sibs = []
    for pnode, pcid in eg.info(cx).parents:
        pn = pnode.canonical(eg.find)
        if pn.op != "slice" or eg.find(pn.children[0]) != eg.find(cx):
            continue
        pa = dict(pn.attrs)
        ps, pl2 = pa["starts"], pa["limits"]
        if all(i == d or (ps[i] == 0 and pl2[i] == base_info.shape[i])
               for i in range(nd)):
            sibs.append((ps[d], pl2[d], eg.find(pcid)))
    sibs = sorted(set(sibs))
    # greedy chain from 0 to extent
    chain, pos = [], 0
    for s, l, c in sibs:
        if s == pos and l > pos:
            chain.append((s, l, c))
            pos = l
        elif s < pos:
            continue
        elif s > pos:
            # gap: chain broken; restart if this piece starts at 0
            if s == 0:
                chain, pos = [(s, l, c)], l
            else:
                return []
    if pos != base_info.shape[d] or len(chain) < 2:
        return []
    return [(eg.find(cx), concat([cls(eg, c) for _, _, c in chain], d))]


# ---------------------------------------------------------------------------
# transpose / reshape structure
# ---------------------------------------------------------------------------

def _transpose_lemmas(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    perm = dict(node.attrs)["perm"]
    eqs = []
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT:
            continue
        eqs.append((cid, concat([transpose(cls(eg, x), perm) for x in xs],
                                perm.index(dim))))
    for base, s, l in slice_reps(eg, cx):
        ns = tuple(s[p] for p in perm)
        nl = tuple(l[p] for p in perm)
        eqs.append((cid, slice_(transpose(cls(eg, base), perm), ns, nl)))
    for n2 in eg.nodes_of(cx, "transpose"):
        inner_perm = dict(n2.attrs)["perm"]
        comp = tuple(inner_perm[p] for p in perm)
        eqs.append((cid, transpose(cls(eg, n2.children[0]), comp)))
    # 2-D: transpose(matmul(a,b)) = matmul(b^T, a^T)
    if perm == (1, 0):
        for n2 in eg.nodes_of(cx, "matmul"):
            a2, b2 = n2.children
            eqs.append((cid, matmul(transpose(cls(eg, b2), (1, 0)),
                                    transpose(cls(eg, a2), (1, 0)))))
    return eqs


def _segments(old_shape, new_shape):
    """Greedy factorization of a reshape into segments: returns a list of
    (old_axes, new_axes) groups with equal products, or None."""
    segs = []
    i = j = 0
    no, nn = len(old_shape), len(new_shape)
    while i < no or j < nn:
        oi, nj = [i], [j]
        if i >= no or j >= nn:
            # trailing 1s
            while i < no:
                if old_shape[i] != 1:
                    return None
                segs.append(((i,), ()))
                i += 1
            while j < nn:
                if new_shape[j] != 1:
                    return None
                segs.append(((), (j,)))
                j += 1
            break
        po, pn = old_shape[i], new_shape[j]
        i += 1
        j += 1
        while po != pn:
            if po < pn:
                if i >= no:
                    return None
                po *= old_shape[i]
                oi.append(i)
                i += 1
            else:
                if j >= nn:
                    return None
                pn *= new_shape[j]
                nj.append(j)
                j += 1
        segs.append((tuple(oi), tuple(nj)))
    return segs


def _reshape_lemmas(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    new_shape = dict(node.attrs)["shape"]
    old_shape = eg.info(cx).shape
    eqs = []
    for n2 in eg.nodes_of(cx, "reshape"):
        eqs.append((cid, reshape(cls(eg, n2.children[0]), new_shape)))
    segs = _segments(old_shape, new_shape)
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT or segs is None:
            continue
        seg = next((s for s in segs if dim in s[0]), None)
        if seg is None or not seg[1]:
            continue
        old_axes, new_axes = seg
        if old_axes.index(dim) != 0:
            continue  # concat axis must be outermost in its segment
        # trailing factor within the segment that each piece must divide
        inner_old = int(np.prod([old_shape[a] for a in old_axes[1:]],
                                dtype=np.int64))
        inner_new = int(np.prod([new_shape[a] for a in new_axes[1:]],
                                dtype=np.int64))
        ndim0 = new_axes[0]
        ok = True
        pieces = []
        for x in xs:
            pc = eg.info(x).shape[dim]
            tot = pc * inner_old
            if tot % inner_new:
                ok = False
                break
            pshape = tuple(tot // inner_new if k == ndim0 else new_shape[k]
                           for k in range(len(new_shape)))
            pieces.append(reshape(cls(eg, x), pshape))
        if ok:
            eqs.append((cid, concat(pieces, ndim0)))
    return eqs


# ---------------------------------------------------------------------------
# broadcast structure
# ---------------------------------------------------------------------------

def _broadcast_lemmas(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    a = dict(node.attrs)
    shape, bdims = a["shape"], a["bdims"]
    eqs = []
    # broadcast of concat distributes when the concat dim survives
    for dim, xs in concat_reps(eg, cx):
        if len(xs) > MAX_FANOUT:
            continue
        od = bdims[dim]
        if eg.info(cx).shape[dim] == shape[od]:
            pieces = []
            for x in xs:
                psh = tuple(eg.info(x).shape[dim] if k == od else shape[k]
                            for k in range(len(shape)))
                pieces.append(broadcast(cls(eg, x), psh, bdims))
            eqs.append((cid, concat(pieces, od)))
    # broadcast of broadcast composes
    for cw, sh2, bd2 in broadcast_reps(eg, cx):
        comp = tuple(bdims[b] for b in bd2)
        eqs.append((cid, broadcast(cls(eg, cw), shape, comp)))
    # identity broadcast
    if eg.info(cx).shape == shape and bdims == tuple(range(len(shape))):
        eqs.append((cid, eg.find(cx)))
    # CONSTRAINED broadcast split (symmetric): among broadcasts of the same
    # source with the same bdims differing in one constant dim, the larger
    # equals a concat of copies of the smaller.
    src_info = eg.info(cx)
    for pnode, pcid in src_info.parents:
        pn = pnode.canonical(eg.find)
        if pn.op != "broadcast" or eg.find(pn.children[0]) != eg.find(cx):
            continue
        pa = dict(pn.attrs)
        if pa["bdims"] != bdims:
            continue
        pshape = pa["shape"]
        if len(pshape) != len(shape):
            continue
        diff = [i for i in range(len(shape)) if pshape[i] != shape[i]]
        if len(diff) != 1:
            continue
        d = diff[0]
        small, big = sorted([(pshape[d], eg.find(pcid)), (shape[d], cid)])
        if small[0] == 0 or big[0] % small[0]:
            continue
        if d in bdims and src_info.shape[bdims.index(d)] != 1:
            continue  # not constant along d
        k = big[0] // small[0]
        if k > MAX_FANOUT or k < 2:
            continue
        piece = cls(eg, small[1])
        eqs.append((big[1], concat([piece] * k, d)))
    return eqs


# ---------------------------------------------------------------------------
# gather (embedding) lemmas
# ---------------------------------------------------------------------------

def _gather_lemmas(eg: EGraph, node: ENode, cid: int):
    ctab, cidx = node.children
    eqs = []
    idx_nd = len(eg.info(cidx).shape)
    for dim, ix in concat_reps(eg, cidx):
        if len(ix) > MAX_FANOUT:
            continue
        eqs.append((cid, concat([gather_rows(cls(eg, ctab), cls(eg, i))
                                 for i in ix], dim)))
    for dim, ts in concat_reps(eg, ctab):
        if dim == 1 and len(ts) <= MAX_FANOUT:  # feature split
            eqs.append((cid, concat([gather_rows(cls(eg, t), cls(eg, cidx))
                                     for t in ts], idx_nd)))
    return eqs


# ---------------------------------------------------------------------------
# algebraic normalization
# ---------------------------------------------------------------------------

def _add_norm(eg: EGraph, node: ENode, cid: int):
    """Flattened n-ary add normal form (replaces assoc/comm saturation).

    Every ``add`` e-node is driven toward one canonical representation:
    addends that are themselves adds are inlined (flattening — this is
    associativity, resolved structurally instead of by generative
    rotation), and the flattened addend list is re-installed sorted by
    e-class id (commutativity — two adds over the same multiset of
    classes meet in the sorted node).  One rewrite per node per round vs
    the old ``add_mul_acom``'s O(Catalan) regrouping saturation, which is
    what blew up the 16-rank ``tp_dp_2d@(4,4)`` psum chains and taxed
    ``fsdp_mlp@8`` ~21 s (EXPERIMENTS.md).  ``mul`` keeps plain binary
    commutativity."""
    op = node.op
    if op == "mul":
        ca, cb = node.children
        return [(cid, ew2("mul", cls(eg, cb), cls(eg, ca)))]
    chs = [eg.find(c) for c in node.children]
    flat = []
    for c in chs:
        reps = sorted(eg.nodes_of(c, "add"),
                      key=lambda n: (len(n.children), n.children))
        if reps and len(flat) + len(reps[0].children) <= MAX_ADD_WIDTH:
            flat.extend(eg.find(x) for x in reps[0].children)
        else:
            flat.append(c)
    canon = sorted(flat)
    if canon == chs:
        return []
    return [(cid, add_n([cls(eg, c) for c in canon]))]


def _sub_to_add(eg: EGraph, node: ENode, cid: int):
    ca, cb = node.children
    return [(cid, ew2("add", cls(eg, ca), ew1("neg", cls(eg, cb))))]


def _neg_identity(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    eqs = []
    for n2 in eg.nodes_of(cx, "neg"):
        eqs.append((cid, eg.find(n2.children[0])))
    return eqs


def _dus_full(eg: EGraph, node: ENode, cid: int):
    cx, cu = node.children
    if eg.info(cx).shape == eg.info(cu).shape:
        return [(cid, eg.find(cu))]
    return []


def _dus_concat(eg: EGraph, node: ENode, cid: int):
    """CONSTRAINED (paper §4.3.2): a *complete* dynamic_update_slice chain
    over a zero-initialized buffer is the concat of its updates:

        dus(dus(zeros, u0, (0, 0)), u1, (k, 0)) = concat(u0, u1, dim=0)

    when the updates exactly tile the buffer (contiguous, non-overlapping)
    along one dim with every other dim written in full.  This is the
    microbatch-accumulation scatter-buffer pattern — per-microbatch grads
    written into a zeros buffer then re-reduced — which EXPERIMENTS.md
    carried as the ``grad_accum`` completeness gap: without this lemma the
    buffer's reduce never equals the sum of the pieces.  Only the chain
    head covers the full buffer, so inner dus nodes bail cheaply."""
    base_shape = eg.info(cid).shape
    nd = len(base_shape)
    d = None
    pieces = []                      # (start, limit, update class)
    cur = node
    base = None
    for _ in range(MAX_FANOUT + 1):
        cx, cu = cur.children
        starts = dict(cur.attrs)["starts"]
        u_shape = eg.info(cu).shape
        if len(u_shape) != nd:
            return []
        dims = [i for i in range(nd)
                if not (starts[i] == 0 and u_shape[i] == base_shape[i])]
        if len(dims) != 1:
            # a full-buffer write anywhere in the chain makes the pieces
            # below it dead (dus_full covers the head case) — treating it
            # as a tile along the other writes' dim would be UNSOUND
            return []
        if d is None:
            d = dims[0]
        elif dims[0] != d:
            return []
        pieces.append((starts[d], starts[d] + u_shape[d], eg.find(cu)))
        subs = sorted(eg.nodes_of(eg.find(cx), "dus"),
                      key=lambda n: (n.attrs, n.children))
        if not subs:
            base = eg.find(cx)
            break
        cur = subs[0]
    # the chain must bottom out in a zero-init buffer (a literal 0 or a
    # broadcast of one — `_lit_of` chases both, cycle-safely)
    if base is None or _lit_of(eg, base) != 0 or d is None:
        return []
    # later writes win, so require a strict non-overlapping exact tiling
    pieces.sort()
    if len(pieces) < 2 or pieces[0][0] != 0 \
            or pieces[-1][1] != base_shape[d]:
        return []
    for (s1, l1, _), (s2, _l2, _) in zip(pieces, pieces[1:]):
        if l1 != s2:
            return []
    return [(cid, concat([cls(eg, c) for _, _, c in pieces], d))]


def _dus_unfold(eg: EGraph, node: ENode, cid: int):
    """A dynamic_update_slice is the concat of the untouched prefix, the
    written window, and the untouched suffix along the first dim the update
    does not cover in full:

        dus(x, u, s) = concat(x[:s_d], inner, x[s_d+u_d:], dim=d)

    where ``inner`` is ``u`` itself when ``d`` is the only partial dim, and
    a residual dus into the sliced slab otherwise (peeling one dim per
    fire).  This is the cache-write normal form servecheck's decode-step
    obligations reduce through: a KV-cache write meets its per-rank sharded
    implementation in slice/concat algebra, where the block lemmas and the
    relation machinery live, instead of as an opaque dus.

    Bounded: one concat and at most two slices per fire, at most ``ndim``
    fires per chain link (chain *heads* over a zero buffer additionally
    collapse to a flat concat via ``dus_concat``)."""
    cx, cu = node.children
    starts = dict(node.attrs)["starts"]
    base_shape = eg.info(cid).shape
    u_shape = eg.info(cu).shape
    nd = len(base_shape)
    if len(u_shape) != nd:
        return []
    d = next((i for i in range(nd)
              if not (starts[i] == 0 and u_shape[i] == base_shape[i])), None)
    if d is None:
        return []                        # full overwrite — dus_full's case
    x, u = cls(eg, cx), cls(eg, cu)
    lo, hi = starts[d], starts[d] + u_shape[d]
    if hi > base_shape[d]:
        return []                        # malformed write — leave it opaque
    others_partial = any(
        i != d and not (starts[i] == 0 and u_shape[i] == base_shape[i])
        for i in range(nd))
    if others_partial:
        slab = slice_(x, tuple(lo if i == d else 0 for i in range(nd)),
                      tuple(hi if i == d else base_shape[i]
                            for i in range(nd)))
        inner = dus(slab, u, tuple(0 if i == d else starts[i]
                                   for i in range(nd)))
    else:
        inner = u
    pieces = []
    if lo > 0:
        pieces.append(slice_(x, (0,) * nd,
                             tuple(lo if i == d else base_shape[i]
                                   for i in range(nd))))
    pieces.append(inner)
    if hi < base_shape[d]:
        pieces.append(slice_(x, tuple(hi if i == d else 0 for i in range(nd)),
                             base_shape))
    return [(cid, concat(pieces, d))]


def _lit_of(eg: EGraph, cid: int, _seen: Optional[set] = None):
    """Return the scalar literal value if this class is lit or broadcast(lit).
    Cycle-safe: merged classes can hold broadcast chains that loop."""
    cid = eg.find(cid)
    if _seen is None:
        _seen = set()
    if cid in _seen:
        return None
    _seen.add(cid)
    for n in eg.nodes_of(cid, "lit"):
        return dict(n.attrs)["value"]
    for n in eg.nodes_of(cid, "broadcast"):
        v = _lit_of(eg, n.children[0], _seen)
        if v is not None:
            return v
    return None


def _mul_lit_fold(eg: EGraph, node: ENode, cid: int):
    """mul(mul(x, c1), c2) = mul(x, c1*c2); div(x, c) = mul(x, 1/c);
    mul(x, 1) = x — scalar-literal algebra (grad-scaling bug family)."""
    op = node.op
    ca, cb = node.children
    eqs = []
    shape = eg.info(cid).shape

    def bl(v):
        t = lit(float(v))
        return broadcast(t, shape, ()) if shape else t

    for left, right in ((ca, cb), (cb, ca)):
        v = _lit_of(eg, right)
        if v is None or v == 0:
            continue
        if op == "div":
            if left is ca:   # only x/c, not c/x
                eqs.append((cid, ew2("mul", cls(eg, ca), bl(1.0 / v))))
            continue
        # op == mul
        if v == 1:
            eqs.append((cid, eg.find(left)))
        for n2 in eg.nodes_of(left, "mul"):
            xa, xb = n2.children
            for l2, r2 in ((xa, xb), (xb, xa)):
                v2 = _lit_of(eg, r2)
                if v2 is not None:
                    eqs.append((cid, ew2("mul", cls(eg, l2), bl(v * v2))))
        for n2 in eg.nodes_of(left, "div"):
            v2 = _lit_of(eg, n2.children[1])
            if v2:
                eqs.append((cid, ew2("mul", cls(eg, n2.children[0]),
                                     bl(v / v2))))
        if op == "mul" and left is ca and right is cb:
            break   # symmetric handling done via loop
    return eqs


def _zero_one_identity(eg: EGraph, node: ENode, cid: int):
    """add(x, 0) = x; mul(x, 1) = x; mul(x, 0) = 0; add(x, x) = 2x.
    n-ary adds drop their literal-zero addends."""
    op = node.op
    eqs = []
    shape = eg.info(cid).shape

    def bl(v):
        t = lit(float(v))
        return broadcast(t, shape, ()) if shape else t

    if op == "add" and len(node.children) != 2:   # n-ary add normal form
        keep = [c for c in node.children if _lit_of(eg, c) != 0]
        if len(keep) == len(node.children):
            return []
        if not keep:
            return [(cid, bl(0.0))]
        if len(keep) == 1:
            return [(cid, eg.find(keep[0]))]
        return [(cid, add_n([cls(eg, c) for c in keep]))]
    ca, cb = node.children

    for left, right in ((ca, cb), (cb, ca)):
        v = _lit_of(eg, right)
        if v is None:
            continue
        if op == "add" and v == 0:
            eqs.append((cid, eg.find(left)))
        if op == "mul" and v == 0:
            eqs.append((cid, bl(0.0)))
    if op == "add" and eg.find(ca) == eg.find(cb) and len(shape) <= 1:
        eqs.append((cid, ew2("mul", cls(eg, ca), bl(2.0))))
    return eqs


def _add_div_dist(eg: EGraph, node: ENode, cid: int):
    """add(div(a,c), ..., div(z,c)) = div(add(a,...,z), c) and the mul
    analogue for literal c — non-generative factoring for the loss-scaling
    bug family, over the flattened n-ary add normal form (every addend
    must carry the same literal factor)."""
    chs = node.children
    eqs = []
    # div: candidate divisors come from the first addend's div reps
    for na in eg.nodes_of(chs[0], "div"):
        va = _lit_of(eg, na.children[1])
        if va is None:
            continue
        nums = [cls(eg, na.children[0])]
        ok = True
        for ch in chs[1:]:
            m = None
            for nb in eg.nodes_of(ch, "div"):
                if _lit_of(eg, nb.children[1]) == va:
                    m = nb.children[0]
                    break
            if m is None:
                ok = False
                break
            nums.append(cls(eg, m))
        if ok:
            eqs.append((cid, ew2("div", add_n(nums),
                                 cls(eg, na.children[1]))))
    for na in eg.nodes_of(chs[0], "mul"):
        for ia in (0, 1):
            va = _lit_of(eg, na.children[ia])
            if va is None:
                continue
            nums = [cls(eg, na.children[1 - ia])]
            ok = True
            for ch in chs[1:]:
                m = None
                for nb in eg.nodes_of(ch, "mul"):
                    for ib in (0, 1):
                        if _lit_of(eg, nb.children[ib]) == va:
                            m = nb.children[1 - ib]
                            break
                    if m is not None:
                        break
                if m is None:
                    ok = False
                    break
                nums.append(cls(eg, m))
            if ok:
                eqs.append((cid, ew2("mul", add_n(nums),
                                     cls(eg, na.children[ia]))))
    return eqs


def _convert_convert(eg: EGraph, node: ENode, cid: int):
    (cx,) = node.children
    to = dict(node.attrs)["to"]
    eqs = []
    for n2 in eg.nodes_of(cx, "convert"):
        eqs.append((cid, convert(cls(eg, n2.children[0]), to)))
    if eg.info(cx).dtype == to:
        eqs.append((cid, eg.find(cx)))
    return eqs


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

LEMMAS: list[Lemma] = [
    Lemma("matmul_block", {"matmul"}, _matmul_block, source="taso"),
    Lemma("bmm_block", {"bmm"}, _bmm_block, source="taso"),
    Lemma("ew1_concat", EW1_OPS | {"integer_pow", "convert"}, _ew1_concat),
    Lemma("ew2_concat", EW2_OPS, _ew2_concat),
    Lemma("select_concat", {"select"}, _select_concat),
    Lemma("reduce_concat", REDUCE_OPS, _reduce_concat),
    Lemma("reduce_broadcast", {"reduce_sum"}, _reduce_broadcast),
    Lemma("reduce_trivial", REDUCE_OPS, _reduce_trivial),
    Lemma("reduce_reshape", {"reduce_sum", "reduce_max", "reduce_min"},
          _reduce_reshape),
    Lemma("scalar_factor", {"mul", "div"}, _scalar_factor),
    Lemma("slice_of_concat", {"slice"}, _slice_of_concat, source="taso"),
    Lemma("slice_of_slice", {"slice"}, _slice_of_slice, source="taso"),
    Lemma("slice_of_ew", {"slice"}, _slice_of_ew),
    Lemma("concat_merge", {"concat"}, _concat_merge, source="taso"),
    Lemma("concat_exchange", {"concat"}, _concat_exchange, source="taso"),
    Lemma("concat_inject", {"concat"}, _concat_inject),
    Lemma("reduce_add", {"reduce_sum"}, _reduce_add),
    Lemma("slice_cover", {"slice"}, _slice_cover),
    Lemma("transpose_alg", {"transpose"}, _transpose_lemmas, source="taso"),
    Lemma("reshape_alg", {"reshape"}, _reshape_lemmas),
    Lemma("broadcast_alg", {"broadcast"}, _broadcast_lemmas),
    Lemma("gather_split", {"gather_rows"}, _gather_lemmas),
    Lemma("add_norm", {"add", "mul"}, _add_norm),
    Lemma("mul_lit_fold", {"mul", "div"}, _mul_lit_fold),
    Lemma("zero_one_identity", {"add", "mul"}, _zero_one_identity),
    Lemma("add_div_dist", {"add"}, _add_div_dist),
    Lemma("sub_to_add", {"sub"}, _sub_to_add),
    Lemma("neg_neg", {"neg"}, _neg_identity),
    Lemma("dus_full", {"dus"}, _dus_full),
    Lemma("dus_concat", {"dus"}, _dus_concat),
    Lemma("dus_unfold", {"dus"}, _dus_unfold),
    Lemma("convert_fold", {"convert"}, _convert_convert),
]

_USER_LEMMAS: list[Lemma] = []


def register_lemma(name: str, ops, fn, source: str = "user") -> Lemma:
    """User extension point (paper §6.5): register a lemma for a custom op."""
    lem = Lemma(name, ops, fn, source=source)
    _USER_LEMMAS.append(lem)
    return lem


def all_lemmas() -> list[Lemma]:
    """The active rule set: built-in LEMMAS plus registered user lemmas."""
    return LEMMAS + _USER_LEMMAS

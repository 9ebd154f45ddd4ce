"""Backward-graph capture: ``torch.func.grad`` over the existing capture.

The forward families in ``repro_torch.dist.strategies`` verify what a rank
*computes*; the training step is about what a rank *differentiates*.  This
module turns a loss function into gradient functions whose ``make_fx``
traces the existing ``repro_torch.core.capture`` machinery lowers like any
other program — the backward pass is just more operators (transposed
matmuls, activation derivatives, broadcast cotangents), so the lemma
engine needs no new concepts.

    seq_grad  = grad_of(loss, argnums=2)          # d loss / d w2
    gs        = capture_grad(loss, avals, names, wrt=2, device="cpu")

``capture_grad_spmd`` is the distributed flavour: the per-rank gradient
function (local backward + whatever collectives the strategy wraps around
it) is traced like any per-rank ``dist_fn``.  ``capture_train_task`` gives
a train obligation's G_s, expanded G_d and R_i, for the scheduler and for
the numeric replay (``schedule.replay_train``).

**The backward form.**  Autograd and JAX's transposition write the same
backward differently, and lemma fires follow the captured def structure.
So every capture here hands the core capture ``_backward_form``, a graph
pass that rewrites the three idioms autograd's formulas emit into the ones
``jax.grad`` emits; a forward capture elsewhere is never rewritten.  (A
``torch._decomp`` table would reach ``tanh_backward`` alone: a
decomposition of ``mm`` sees its operands' values, not that one of them
is autograd's ``t``.)

* ``mm(g, w.t())`` (the gradient of a product's left operand) becomes one
  ``matmul(g, transpose(w))``;
* ``mm(a.t(), g)`` (of its right operand) becomes
  ``transpose(matmul(transpose(g), a))``, a def each, as JAX's transpose
  rule for ``dot_general``'s right operand computes it;
* ``tanh_backward(g, y)`` becomes ``g (1 - y) + g (1 - y) y`` with the
  ``1 - y`` defined right after ``y = tanh(.)``, where JAX's linearization
  puts it.

``aten.t`` is what autograd's ``mm`` formulas emit (a user's ``x.T`` is a
``permute``), and only a ``t`` that feeds nothing but the product is
rewritten.  The loss's own forward ``sum`` stays in the graph, dead, as it
stays in the jaxpr.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from ..api.spec import StrategySpec
from ..core.capture import (Graph, SpmdCapture, capture, capture_spmd,
                            expand_spmd, matmul_nd)
from ..models.registry import resolve_device
from ..obs import trace as obs_trace

aten = torch.ops.aten


def grad_of(loss_fn: Callable, argnums: Union[int, Sequence[int]]
            ) -> Callable:
    """The gradient function of a scalar loss w.r.t. ``argnums``.

    A thin, named wrapper over ``torch.func.grad`` so obligations read as
    what they verify (``grad_of(loss, 2)`` = the w2 gradient of the step).
    """
    argnums = argnums if isinstance(argnums, int) else tuple(argnums)
    return torch.func.grad(loss_fn, argnums=argnums)


def _is_t(node) -> bool:
    return getattr(node, "op", None) == "call_function" \
        and node.target is aten.t.default and len(node.users) == 1


def _node(graph, target, args, like, meta_from):
    node = graph.call_function(target, args)
    node.meta.update(meta_from.meta)
    node.meta["val"] = like
    return node


def _backward_form(gm) -> None:
    """Rewrite autograd's backward idioms in ``gm`` into JAX's (see the
    module docstring)."""
    graph = gm.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten.mm.default:
            a, b = node.args
            if _is_t(b):                       # mm(g, w.t())
                with graph.inserting_before(node):
                    new = _node(graph, matmul_nd,
                                (a, (0, 1), b.args[0], (1, 0)),
                                node.meta["val"], node)
                dead = [node, b]
            elif _is_t(a):                     # mm(a.t(), g)
                val = node.meta["val"]
                with graph.inserting_before(node):
                    inner = _node(graph, matmul_nd,
                                  (b, (1, 0), a.args[0], (0, 1)),
                                  val.t(), node)
                    new = _node(graph, aten.permute.default, (inner, [1, 0]),
                                val, node)
                dead = [node, a]
            else:
                continue
        elif node.target is aten.tanh_backward.default:
            g, y = node.args
            val = node.meta["val"]
            with graph.inserting_after(y):
                one_minus = _node(graph, aten.rsub.Scalar, (y, 1), val, node)
            with graph.inserting_before(node):
                m1 = _node(graph, aten.mul.Tensor, (g, one_minus), val, node)
                m2 = _node(graph, aten.mul.Tensor, (m1, y), val, node)
                new = _node(graph, aten.add.Tensor, (m1, m2), val, node)
            dead = [node]
        else:
            continue
        node.replace_all_uses_with(new)
        for n in dead:
            graph.erase_node(n)
    graph.lint()


def capture_backward(grad_fn: Callable, avals: Sequence,
                     names: Sequence[str], device=None) -> Graph:
    """Capture a gradient function (``grad_of(loss, ...)`` and whatever
    surrounds it) as a sequential :class:`Graph` on ``device``, in
    ``jax.grad``'s backward form."""
    return capture(grad_fn, list(avals), list(names), device=device,
                   fx_pass=_backward_form)


def capture_grad(loss_fn: Callable, avals: Sequence, names: Sequence[str],
                 wrt: Union[int, Sequence[int]], device=None) -> Graph:
    """Capture the backward graph of ``loss_fn`` w.r.t. ``wrt`` as a
    sequential :class:`Graph` (the G_s of a train-step obligation), traced
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    return capture_backward(grad_of(loss_fn, wrt), avals, names, device)


def capture_grad_spmd(dist_grad_fn: Callable, mesh_axes: dict,
                      in_specs: Sequence, avals: Sequence,
                      names: Sequence[str], device=None) -> SpmdCapture:
    """Capture a per-rank gradient implementation (local backward +
    explicit collectives) — the G_d of a train-step obligation, in
    ``jax.grad``'s backward form."""
    return capture_spmd(dist_grad_fn, mesh_axes, list(in_specs),
                        list(avals), list(names), device=device,
                        fx_pass=_backward_form)


def capture_train_task(spec: StrategySpec, device=None) -> tuple:
    """G_s, the expanded G_d and R_i of one parameter's gradient
    obligation (``spec.seq_fn`` is already ``grad_of(loss, param)``),
    traced on ``device``."""
    dev = resolve_device(device)
    with obs_trace.span("capture", cat="capture", graph="gs",
                        case=spec.name):
        gs = capture_backward(spec.seq_fn, spec.avals, spec.input_names,
                              dev)
    with obs_trace.span("capture", cat="capture", graph="gd",
                        case=spec.name):
        gd, r_i = expand_spmd(capture_grad_spmd(
            spec.dist_fn, spec.mesh_axes, spec.in_specs, spec.avals,
            spec.input_names, dev))
    return gs, gd, r_i

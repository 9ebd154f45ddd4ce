"""Strict capture frontend for the torch graphs (counterpart of the JAX
package's ``from_jaxpr.py``).

The capture raises ``CaptureError`` for an aten op outside its table. Under
:func:`strict_capture` it raises :class:`UnsupportedPrimitive` instead,
naming the op and the **source location** of the user code that emitted it
(``file:line (function)``, from the node's ``meta["stack_trace"]``, which
the capture stamps while it traces), e.g.::

    UnsupportedPrimitive: primitive `aten.cumprod` at my_model.py:42
    (block) has no term-language lowering: no lowering to the term
    vocabulary

``SUPPORTED_PRIMITIVES`` is the table: the aten ops, and the SPMD shim's
ops, that have a lowering.

:func:`capture_function` and :func:`capture_spmd_function` trace arbitrary
user functions (the ``verify_functions`` API and the ``--fn`` CLI flag),
always strictly. Their inputs give only shapes and dtypes; capture is
``make_fx`` in real mode, so the tracing tensors are made on the resolved
device from a seeded ``torch.Generator`` (``capture.py``'s, the same as
for the registered cases).
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Iterator, Optional, Sequence

from ..models.registry import resolve_device
from .capture import (SUPPORTED_PRIMITIVES, CaptureError, Graph,
                      SpmdCapture, _NODE_HOOKS, op_name, source_location)
from .capture import capture as _capture
from .capture import capture_spmd as _capture_spmd

__all__ = ["SUPPORTED_PRIMITIVES", "UnsupportedPrimitive", "strict_capture",
           "capture_function", "capture_spmd_function",
           "default_input_names", "normalize_mesh"]

class UnsupportedPrimitive(CaptureError):
    """A traced node has no clean lowering into the term language.

    Carries the offending ``primitive`` (``aten.op`` name), its ``source``
    location (``file:line (function)`` of the user code that emitted it),
    and the ``reason`` the lowering was refused.
    """

    def __init__(self, primitive: str, source: str, reason: str = ""):
        self.primitive = str(primitive)
        self.source = str(source)
        self.reason = str(reason)
        msg = (f"primitive `{self.primitive}` at {self.source} has no "
               f"term-language lowering")
        if reason:
            msg += f": {reason}"
        super().__init__(msg)


@contextlib.contextmanager
def strict_capture() -> Iterator[None]:
    """Make every capture refusal raise :class:`UnsupportedPrimitive` with
    the node's op name and source location, for the dynamic extent of the
    block."""
    def hook(node, reason: str) -> None:
        raise UnsupportedPrimitive(op_name(node), source_location(node),
                                   reason)

    _NODE_HOOKS.append(hook)
    try:
        yield
    finally:
        _NODE_HOOKS.remove(hook)


def default_input_names(fn: Callable, n: int) -> list:
    """Input names for ``fn``: its positional parameter names when the
    signature is introspectable (and fully positional), else ``arg0..``."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        params = []
    names = [p.name for p in params
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return names if len(names) == n else [f"arg{i}" for i in range(n)]


def normalize_mesh(mesh) -> dict:
    """Coerce a mesh argument to the ``{axis name: size}`` dict form.

    Accepts a plain dict, an object whose ``.shape`` is such a mapping, or
    anything ``dict()`` takes (``[("dp", 2), ("tp", 4)]``).
    """
    if isinstance(mesh, dict):
        out = {str(k): int(v) for k, v in mesh.items()}
    elif hasattr(mesh, "shape") and hasattr(mesh.shape, "items"):
        out = {str(k): int(v) for k, v in mesh.shape.items()}
    else:
        try:
            out = {str(k): int(v) for k, v in dict(mesh).items()}
        except (TypeError, ValueError):
            raise TypeError(
                f"mesh must be a {{axis: size}} dict or a sequence of "
                f"(axis, size) pairs, got {type(mesh).__name__}") from None
    if not out or any(v < 1 for v in out.values()):
        raise ValueError(f"mesh axes must have positive sizes, got {out}")
    return out


def capture_function(fn: Callable, avals: Sequence,
                     names: Optional[Sequence[str]] = None, *,
                     device=None) -> Graph:
    """Trace ``fn`` with ``make_fx`` and lower it to a :class:`Graph`,
    strictly: an op outside the term vocabulary raises
    :class:`UnsupportedPrimitive`.

    The generic flavour of ``capture()``: ``avals`` are ``(shape, dtype)``
    pairs (``TensorSpec``), ``names`` default to the function's own
    parameter names, and the trace runs on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for).
    """
    dev = resolve_device(device)
    if names is None:
        names = default_input_names(fn, len(avals))
    with strict_capture():
        return _capture(fn, list(avals), list(names), device=dev)


def capture_spmd_function(fn: Callable, mesh, in_specs: Sequence,
                          avals: Sequence,
                          names: Optional[Sequence[str]] = None, *,
                          device=None) -> SpmdCapture:
    """Trace a per-rank SPMD ``fn`` strictly on per-shard tensors of the
    global ``avals``.

    The generic flavour of ``capture_spmd()``: ``mesh`` is anything
    :func:`normalize_mesh` takes, ``names`` default to the function's
    parameter names, and the trace runs on ``device``.  The returned
    :class:`SpmdCapture` expands to a multi-rank graph + input relation
    via ``expand_spmd``.
    """
    mesh_axes = normalize_mesh(mesh)
    dev = resolve_device(device)
    if names is None:
        names = default_input_names(fn, len(avals))
    with strict_capture():
        return _capture_spmd(fn, mesh_axes, list(in_specs), list(avals),
                             list(names), device=dev)

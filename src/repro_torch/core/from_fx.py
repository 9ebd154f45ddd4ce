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
ops, that have a lowering. Tracing arbitrary function pairs
(``capture_function``/``verify_functions`` and the ``--fn`` CLI flag) is
not ported yet.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from .capture import (SUPPORTED_PRIMITIVES, CaptureError, _NODE_HOOKS,
                      op_name, source_location)

__all__ = ["SUPPORTED_PRIMITIVES", "UnsupportedPrimitive", "strict_capture"]


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

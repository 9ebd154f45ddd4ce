"""Graphs carried across from their plain object form.

A ``Graph`` and its input relation R_i travel between packages as plain
Python objects: ``term_to_obj`` dicts for terms, lists and dicts for the
graph's fields, numpy arrays for its constants. :func:`graph_from_obj`
and :func:`relation_from_obj` rebuild the port's ``Graph`` and R_i from
them, so a graph captured elsewhere (the JAX package's tests carry their
captures this way) runs through the port's engine unchanged. Nothing here
imports the package that produced the objects.
"""
from __future__ import annotations

import numpy as np

from .capture import Graph
from .explain import term_from_obj

__all__ = ["graph_from_obj", "relation_from_obj", "term_from_obj"]


def graph_from_obj(obj: dict) -> Graph:
    """A port ``Graph`` from ``{"inputs", "outputs", "defs": [[name,
    term obj]], "shapes", "dtypes", "consts": {name: array}}``."""
    return Graph(
        inputs=list(obj["inputs"]), outputs=list(obj["outputs"]),
        defs=[(n, term_from_obj(t)) for n, t in obj["defs"]],
        shapes={k: tuple(v) for k, v in obj["shapes"].items()},
        dtypes=dict(obj["dtypes"]),
        consts={k: np.asarray(v) for k, v in obj.get("consts", {}).items()})


def relation_from_obj(obj: dict) -> dict:
    """R_i (``{input name: [Term, ...]}``) from ``{name: [term obj]}``."""
    return {n: [term_from_obj(t) for t in terms] for n, terms in obj.items()}

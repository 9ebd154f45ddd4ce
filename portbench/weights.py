"""Weights from the seed: one flat buffer on the device, drawn in a few
large calls, each leaf a view of it scaled to its std.

The layout (names, shapes, kinds) is the plain reference's; the program's
model, built on the meta device, gets views of the same buffer under the
same names as its parameters, and the reference, after the window, draws
the buffer again from the same seed.
"""
from __future__ import annotations

import math

import torch

# Each leaf starts on a 256-byte boundary (tensor-map and bulk-copy bases
# need 16; the libraries' products prefer 256).
ALIGN_BYTES = 256
DRAW = 1 << 30          # elements a normal_ call draws
NORM_STD = 0.1          # the (1 + scale) norm scales: scale ~ N(0, 0.1^2)


def std(shape, kind: str) -> float:
    """A matrix: 1 / sqrt(fan_in), fan_in its second-to-last dim; a norm
    scale: NORM_STD."""
    if kind == "norm":
        return NORM_STD
    return 1.0 / math.sqrt(shape[-2])


def offsets(layout, dtype):
    """{name: (offset, shape)} in the flat buffer, and its length."""
    align = ALIGN_BYTES // torch.tensor([], dtype=dtype).element_size()
    out, pos = {}, 0
    for name, shape, _kind in layout:
        out[name] = (pos, tuple(shape))
        pos += -(-math.prod(shape) // align) * align
    return out, pos


@torch.no_grad()
def make(layout, seed: int, device, dtype=torch.bfloat16):
    """``(flat, views)``: the flat buffer drawn from ``seed`` (normal draws
    in ``dtype``, DRAW elements a call) and ``{name: view}``, each view
    scaled by its leaf's ``std``."""
    offs, n = offsets(layout, dtype)
    flat = torch.empty(n, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    for i in range(0, n, DRAW):
        flat[i:i + DRAW].normal_(0.0, 1.0, generator=g)
    views = {}
    for name, shape, kind in layout:
        off, shp = offs[name]
        v = flat[off:off + math.prod(shp)].view(shp)
        v.mul_(std(shp, kind))
        views[name] = v
    return flat, views


def bind(model, views) -> None:
    """Replace each of the program's parameters by a parameter over its
    view (names and shapes must be the layout's exactly). The model is
    built on the meta device, so that its own parameters take no memory."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(views):
        raise ValueError(f"the program's parameters {sorted(set(params) ^ set(views))} "
                         "differ from the reference layout's")
    for name, p in params.items():
        v = views[name]
        if tuple(p.shape) != tuple(v.shape) or p.dtype != v.dtype:
            raise ValueError(f"{name}: program {tuple(p.shape)} {p.dtype}, "
                             f"layout {tuple(v.shape)} {v.dtype}")
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(
            leaf, torch.nn.Parameter(v, requires_grad=p.requires_grad))

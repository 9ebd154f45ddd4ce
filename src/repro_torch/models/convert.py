"""Turn the JAX package's parameter tree into the port's model.

The tree comes as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs neither JAX nor ``repro``. The JAX families stack their
layers for ``lax.scan``; ``registry.layer_groups`` says where each port
layer sits in the JAX tree:

- dense, vlm, moe and hybrid: ``blocks/p{i}`` holds, along axis 0, the
  layers at pattern position ``i`` of every repetition ``g``, i.e. layer
  ``g*P + i``; the ``n_layers % P`` remainder layers follow under
  ``tail/p{i}`` as layer ``reps*P + i`` (hybrid's tail layers carry
  their role's leaves);
- ssm: ``blocks`` stacks all layers, with no ``p{i}`` level;
- audio: ``enc_blocks`` and ``dec_blocks`` stack the encoder's and the
  decoder's layers.

The port keeps the JAX ``(d_in, d_out)`` layout, so no weight is
transposed. ``to_jax`` goes the other way: the port's parameters in the
JAX tree's layout, as the checkpoint format writes them.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from . import registry


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def state_from_jax(params: dict, cfg: ModelConfig) -> dict:
    """The JAX tree as a flat {port parameter name: numpy array} dict."""
    groups = registry.layer_groups(cfg)
    stacked_keys = {path[0] for _, path, _ in groups}
    state = dict(_flat({k: v for k, v in params.items()
                        if k not in stacked_keys}))
    for name, path, layers in groups:
        node = params
        for key in path:
            node = node[key]
        for leaf, arr in _flat(node):
            if isinstance(layers, int):
                state[f"{name}.{layers}.{leaf}"] = arr
                continue
            if arr.shape[0] != len(layers):
                raise ValueError(f"{'/'.join(path)}/{leaf}: {arr.shape[0]} "
                                 f"stacked layers, the config has "
                                 f"{len(layers)}")
            for g, layer in enumerate(layers):
                state[f"{name}.{layer}.{leaf}"] = arr[g]
    return state


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes; exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@torch.no_grad()
def from_jax(params: dict, cfg: ModelConfig, device=None):
    """The port's model holding the JAX weights, on ``device``."""
    model = registry.build_model(cfg, device)
    state = state_from_jax(params, cfg)
    names = dict(model.named_parameters())
    if set(names) != set(state):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(names) - set(state))}, only in JAX "
                         f"{sorted(set(state) - set(names))}")
    for name, p in names.items():
        t = _tensor(state[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} != port "
                             f"shape {tuple(p.shape)}")
        p.copy_(t)
    return model


def _nest(flat: dict) -> dict:
    """{"a.b": v} -> {"a": {"b": v}}."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return out


@torch.no_grad()
def to_jax(model) -> dict:
    """The model's parameters as the JAX package's tree (detached tensors
    on the model's device): each layer group stacked along a new axis 0
    where the JAX family scans it. The inverse of :func:`state_from_jax`."""
    groups = registry.layer_groups(model.cfg)
    params = {n: p.detach() for n, p in model.named_parameters()}
    lists = {name for name, _, _ in groups}
    tree = _nest({n: v for n, v in params.items()
                  if n.split(".")[0] not in lists})
    for name, path, layers in groups:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        first = layers if isinstance(layers, int) else layers[0]
        prefix = f"{name}.{first}."
        leaves = [n[len(prefix):] for n in params if n.startswith(prefix)]
        node[path[-1]] = _nest({
            leaf: params[prefix + leaf] if isinstance(layers, int)
            else torch.stack([params[f"{name}.{i}.{leaf}"] for i in layers])
            for leaf in leaves})
    return tree

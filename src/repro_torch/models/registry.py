"""Architecture registry: uniform API over the six model families.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` they raise rather than run on the CPU.
``abstract_params`` and ``init_cache(..., abstract=True)`` build on the
meta device: shapes and dtypes, no memory (the dry run's stand-ins).
"""
from __future__ import annotations

import importlib
import math

import torch

from ..device import resolve_device  # noqa: F401 (the entry points' rule)
from .config import ModelConfig
from . import dense, encdec, hybrid, layers as L, moe, ssm

_FAMILY = {
    "dense": dense, "vlm": dense, "moe": moe, "ssm": ssm,
    "hybrid": hybrid, "audio": encdec,
}

ARCH_IDS = [
    "gemma3-27b", "mixtral-8x7b", "mamba2-1.3b", "kimi-k2-1t-a32b",
    "recurrentgemma-2b", "qwen2-vl-2b", "gemma3-12b", "whisper-medium",
    "yi-9b", "command-r-35b",
]


def family_module(cfg: ModelConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"({cfg.name}); known: {sorted(_FAMILY)}")
    return mod


def model_spec(cfg: ModelConfig) -> dict:
    return family_module(cfg).model_spec(cfg)


def build_model(cfg: ModelConfig, device=None) -> L.Model:
    """The family's model with uninitialised weights on ``device``."""
    return L.Model(model_spec(cfg), cfg, resolve_device(device))


def abstract_params(cfg: ModelConfig) -> L.Model:
    """The model on the meta device: every parameter's shape and dtype (the
    JAX package's ``abstract_tree``), no memory allocated."""
    return L.Model(model_spec(cfg), cfg, torch.device("meta"))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> L.Model:
    """The model with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (std = scale / sqrt(fan_in), ones for norm
    leaves of scale -1: the JAX package's rule; the bits differ from
    ``jax.random``)."""
    model = build_model(cfg, device)
    dev = next(model.parameters()).device
    L.init_tree(model, torch.Generator(device=dev).manual_seed(seed))
    return model


# The JAX package's scanned stacks: (the port's ModuleList, the JAX tree
# path of the group, the port's layer indices stacked in it, or an int for
# one unstacked layer), in the JAX tree's order.
def layer_groups(cfg: ModelConfig) -> list:
    if cfg.family == "ssm":
        return [("blocks", ("blocks",), list(range(cfg.n_layers)))]
    if cfg.family == "audio":
        return [("enc_blocks", ("enc_blocks",),
                 list(range(cfg.encoder_layers))),
                ("dec_blocks", ("dec_blocks",), list(range(cfg.n_layers)))]
    P = len(cfg.pattern)
    reps, tail = divmod(cfg.n_layers, P)
    return [("blocks", ("blocks", f"p{i}"), [g * P + i for g in range(reps)])
            for i in range(P)] + [("blocks", ("tail", f"p{i}"), reps * P + i)
                                  for i in range(tail)]


def logical_axes(cfg: ModelConfig) -> dict:
    """The JAX package's ``logical_axes(cfg)``: each leaf's logical
    sharding axes, in its tree, with ``"layers"`` in front of stacked
    leaves."""
    spec = model_spec(cfg)
    out = {k: (v.logical if isinstance(v, L.Leaf) else L.logical_tree(v))
           for k, v in spec.items() if not isinstance(v, list)}
    for name, path, layers in layer_groups(cfg):
        first = layers[0] if isinstance(layers, list) else layers
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = L.logical_tree(spec[name][first],
                                        stacked=isinstance(layers, list))
    return out


def forward(model, batch: dict, return_hidden=False):
    """batch: {tokens, positions?, patch_embeds?, frames?} -> (logits,
    extras): the family's extras (moe: {"aux_loss"}; others None)."""
    cfg = model.cfg
    kwargs = {}
    if cfg.family == "vlm" and "patch_embeds" in batch:
        kwargs["patch_embeds"] = batch["patch_embeds"]
    if cfg.family == "audio":
        kwargs["frames"] = batch["frames"]
    return family_module(cfg).forward(model, batch["tokens"],
                                      positions=batch.get("positions"),
                                      return_hidden=return_hidden, **kwargs)


def init_cache(model, batch: int, max_seq: int, abstract: bool = False):
    """The family's decode cache, zeros on the model's device; with
    ``abstract`` on the meta device, and ``model`` may be its config."""
    if abstract:
        cfg = model if isinstance(model, ModelConfig) else model.cfg
        return family_module(cfg).init_cache(cfg, batch, max_seq,
                                             torch.device("meta"))
    dev = next(model.parameters()).device
    return family_module(model.cfg).init_cache(model.cfg, batch, max_seq, dev)


def decode_step(model, cache, token, pos: int):
    return family_module(model.cfg).decode_step(model, cache, token, pos)


def load_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(lf.shape) for lf in L.spec_leaves(model_spec(cfg)))


def n_active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k of n_experts)."""
    total = n_params(cfg)
    if cfg.n_experts and cfg.top_k:
        expert_p = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_experts \
            * cfg.n_layers
        active = expert_p * cfg.top_k // cfg.n_experts
        return total - expert_p + active
    return total

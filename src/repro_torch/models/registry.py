"""Architecture registry: uniform API over the ported model families.

Only the ``dense`` family is ported so far; the others raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` they raise rather than run on the CPU.
"""
from __future__ import annotations

import importlib
import math

import torch

from .config import ModelConfig
from . import dense, layers as L

_FAMILY = {"dense": dense}
_LATER = ("ROADMAP.md, queue 1, item 5 (remaining model families: moe, ssm, "
          "hybrid, vlm, audio)")


def family_module(cfg: ModelConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet; see {_LATER}")
    return mod


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``, which must then exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; repro_torch runs on "
                           "the GPU unless called with device='cpu'")
    return torch.device("cuda")


def model_spec(cfg: ModelConfig) -> dict:
    return family_module(cfg).model_spec(cfg)


def build_model(cfg: ModelConfig, device=None):
    """The family's model with uninitialised weights on ``device``."""
    mod = family_module(cfg)
    return mod.DenseLM(cfg, resolve_device(device))


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The model with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (std = scale / sqrt(fan_in), the JAX
    package's rule; the bits differ from ``jax.random``)."""
    model = build_model(cfg, device)
    dev = next(model.parameters()).device
    L.init_tree(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def forward(model, batch: dict):
    """batch: {tokens} at positions 0..S-1 -> (logits, None)."""
    if "positions" in batch:
        raise NotImplementedError("explicit positions are not ported; "
                                  "prefill runs positions 0..S-1")
    return family_module(model.cfg).forward(model, batch["tokens"]), None


def init_cache(model, batch: int, max_seq: int):
    dev = next(model.parameters()).device
    return family_module(model.cfg).init_cache(model.cfg, batch, max_seq, dev)


def decode_step(model, cache, token, pos: int):
    return family_module(model.cfg).decode_step(model, cache, token, pos)


def load_config(arch_id: str) -> ModelConfig:
    name = arch_id.replace('-', '_').replace('.', '_')
    try:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"repro_torch.configs.{name}":
            raise
        raise NotImplementedError(
            f"config {arch_id!r} is not ported to repro_torch yet; "
            f"see {_LATER}") from None
    return mod.CONFIG


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(lf.shape) for lf in L.spec_leaves(model_spec(cfg)))

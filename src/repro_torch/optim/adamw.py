"""AdamW with fp32 moments and optional global-norm clipping.

The JAX package's optimizer, as functions over a model's named parameters
(``dict(model.named_parameters())``) rather than a pytree. Its semantics
are that package's, which differ from ``torch.optim.AdamW``'s: the
gradients are clipped to a global norm first, the weight decay is added
into the update (not decoupled from the learning rate), the learning rate
warms up linearly from 0, and each update is applied in fp32 and cast back
to the parameter's dtype. ``update`` writes the new values into the
parameters and the state in place, which saves a copy of every parameter
and moment; it returns them too, in the JAX package's order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init(params: dict) -> dict:
    """``{"mu", "nu", "step"}``: fp32 zeros per parameter and a 0-d int32
    step count, on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor): linear warmup to ``lr``."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    """One AdamW step. ``grads`` and ``params`` map the same names to
    tensors; returns ``(params, state, grad_norm)`` with ``params`` and
    ``state`` updated in place. ``grad_norm`` (0-d fp32) is the global
    norm before clipping, 0 when clipping is off. Nothing here waits for
    the device."""
    step = state["step"] + 1
    scale = None
    if cfg.clip_norm:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), device=step.device)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    lr = schedule(cfg, step)
    # one parameter at a time: a leaf's fp32 temporaries are freed before
    # the next one's are made
    for n, p in params.items():
        g = grads[n].float()
        if scale is not None:
            g = g * scale
        m = state["mu"][n]
        v = state["nu"][n]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, gnorm

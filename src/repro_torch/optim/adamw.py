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

from ..kernels import adamw as kernels
from ..obs import trace as obs_trace


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


def step_scalars(state: dict, cfg: AdamWConfig):
    """``(step, lr, bc1, bc2)`` of the next update: the new step count, its
    learning rate and the moments' bias corrections, 0-d on the step
    count's device."""
    step = state["step"] + 1
    t = step.float()
    return step, schedule(cfg, step), 1 - cfg.b1 ** t, 1 - cfg.b2 ** t


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    """One AdamW step. ``grads`` and ``params`` map the same names to
    tensors; returns ``(params, state, grad_norm)`` with ``params`` and
    ``state`` updated in place. ``grad_norm`` (0-d fp32) is the global
    norm before clipping, 0 when clipping is off. Plain CUDA tensors take
    the kernels (``kernels.adamw.update``), which launch or raise; the
    CPU, DTensors, fake and meta tensors take their plain version
    (``kernels.adamw.update_plain``). Nothing here waits for the device.
    Span: ``rt.adamw.update``."""
    with obs_trace.span("rt.adamw.update"):
        step, lr, bc1, bc2 = step_scalars(state, cfg)
        run = kernels.update if kernels.takes_kernels(params, grads) \
            else kernels.update_plain
        gnorm = run(grads, state["mu"], state["nu"], params, cfg, lr, bc1,
                    bc2)
        state["step"] = step
        return params, state, gnorm

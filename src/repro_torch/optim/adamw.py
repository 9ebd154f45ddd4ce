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

from ..obs import trace as obs_trace
from ..sharding.specs import is_dtensor

# A leaf's update in fp32 makes a few temporaries of the leaf's size; a leaf
# of more elements than this is updated a run of rows at a time, so that
# they stay within ~5 x 256 MB (a 256k-row embedding's would be ~40 GB).
# Each element's arithmetic is the same either way.
UPDATE_CHUNK = 1 << 26


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
    the device. Span: ``rt.adamw.update``."""
    with obs_trace.span("rt.adamw.update"):
        return _update(grads, state, params, cfg)


def _update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    step = state["step"] + 1
    scale = None
    if cfg.clip_norm:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(gp.float()))
                               for g in grads.values()
                               for (gp,) in _pieces(g)))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), device=step.device)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    lr = schedule(cfg, step)
    # one parameter (or run of its rows) at a time: its fp32 temporaries
    # are freed before the next one's are made
    for n, p in params.items():
        for pp, gp, m, v in _pieces(p, grads[n], state["mu"][n],
                                    state["nu"][n]):
            g = gp.float()
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = pp.float()
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * pf
            pp.copy_((pf - lr * delta).to(pp.dtype))
    state["step"] = step
    return params, state, gnorm


def _pieces(*ts):
    """``ts`` (tensors of one shape) whole, or, past UPDATE_CHUNK elements,
    as views of runs of their leading rows of at most UPDATE_CHUNK elements
    (or one row); a DTensor is left whole, as its shards are."""
    t = ts[0]
    if t.numel() <= UPDATE_CHUNK or t.dim() == 0 or is_dtensor(t):
        yield ts
        return
    rows = max(1, UPDATE_CHUNK * t.shape[0] // t.numel())
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)

"""Device dispatch for the kernels.

A CPU tensor goes to the kernel's plain version. A CUDA tensor goes to the
kernel, which launches or raises: there is no fallback. Any other device
raises. On CUDA, a call that autograd records (grad enabled and an input
that requires grad) goes through the kernel's ``autograd.Function``, whose
forward launches the same kernel; every other call launches it directly,
without autograd's host cost. Each kernel wrapper counts its launches
(``launch_counts``), on both branches: RMSNorm in all and per launch plan
(``rmsnorm_rows``, ``rmsnorm_ring``); attention per route (bf16 on tensor
cores, fp32 scalar), with ``flash_attention`` their sum."""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import rmsnorm as _rn

_KERNELS = {"rmsnorm": _rn.rmsnorm,
            **{f"flash_attention_{r}": fn for r, fn in _fa.KERNELS.items()}}


def _route(t, name):
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _recorded(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x, scale, eps: float = 1e-6):
    if _route(x, "rmsnorm"):
        if _recorded(x, scale):
            return _rn.RMSNormFunction.apply(x, scale, eps)
        return _rn.rmsnorm(x, scale, eps)
    return _rn.rmsnorm_plain(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    if _route(q, "flash_attention"):
        if _recorded(q, k, v):
            return _fa.FlashAttentionFunction.apply(q, k, v, causal)
        return _fa.flash_attention(q, k, v, causal=causal)
    return _fa.flash_attention_plain(q, k, v, causal=causal)


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in _KERNELS.items()}
    counts.update({f"rmsnorm_{name}": n
                   for name, n in _rn.rmsnorm.plan_launches.items()})
    counts["flash_attention"] = sum(fn.launches for fn in _fa.KERNELS.values())
    return counts


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
    _rn.rmsnorm.plan_launches = dict.fromkeys(_rn.rmsnorm.plan_launches, 0)
    _rn.rmsnorm.row_launches.clear()

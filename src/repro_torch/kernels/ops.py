"""Device dispatch for the kernels.

A CPU tensor goes to the kernel's plain version. A CUDA tensor goes to the
kernel, which launches or raises: there is no fallback. Any other device
raises. On CUDA, a call that autograd records (grad enabled and an input
that requires grad) goes through the kernel's ``autograd.Function``, whose
forward launches the same kernel and whose backward launches the kernel's
backward (K1: ``rmsnorm_bwd``; K2: ``flash_attention_bwd_bf16`` or
``flash_attention_bwd_fp32`` by dtype, from the output and log-sum-exp the
forward saved); every other call launches the forward directly, without
autograd's host cost and without the LSE. The
closed forms (``rmsnorm_backward``, ``flash_attention_backward``) are the
backward kernels' plain versions: the CPU's gradients. Each kernel wrapper
counts its launches (``launch_counts``), on both branches: RMSNorm in all
and per launch plan (``rmsnorm_rows``, ``rmsnorm_ring``), its backward
(``rmsnorm_bwd``); attention per route (bf16 on ``wgmma``, fp32 in
3xTF32 on ``mma.sync``), with ``flash_attention`` their sum, and each route's backward
(``flash_attention_bwd_bf16``, ``flash_attention_bwd_fp32``); and AdamW's
two kernels (``adamw_sumsq``, ``adamw_update``, a launch a leaf each),
which ``optim.adamw.update`` routes by the same rule (``kernels/adamw.py``).
K2 takes a causal sliding window (``window``, 0 = none) on every branch; a
window without the causal mask raises.

A DTensor (a parameter or activation on a ``DeviceMesh``) or a fake tensor
(the dry run's ``FakeTensorMode``) takes neither branch: it goes through
the kernel's custom op, ``repro_torch::rmsnorm`` or
``repro_torch::flash_attention`` (which also returns the LSE, (B, H, 0)
unless autograd records the call), whose autograd formula calls the
backward's op, ``repro_torch::rmsnorm_backward`` or
``repro_torch::flash_attention_backward``, on the local shards. Each op
has a fake implementation (shapes and dtypes only: under the fake mode
nothing launches) and a FLOP formula (the kernel's own arithmetic, for
``torch.utils.flop_counter``); the forward ops a DTensor sharding rule
(K1: any dim but the last sharded; K2: batch, or heads where q's and
k/v's head shards line up). Each op's real implementation is the dispatch
above on the local shard, so on a real mesh the shard reaches the same
hand-written kernel, forward and backward. K2's GQA case where k/v's
heads are replicated while q's are sharded (KV not divisible by the mesh
axis) runs the kernel on each rank's q heads and the KV heads they read,
sliced by the rank's mesh coordinate (``sharding.specs.heads_local``)."""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from ..sharding.specs import heads_local, is_dtensor, is_wrapped
from . import adamw as _aw
from . import flash_attention as _fa
from . import rmsnorm as _rn

_KERNELS = {"rmsnorm": _rn.rmsnorm, "rmsnorm_bwd": _rn.rmsnorm_bwd,
            **{f"flash_attention_{r}": fn for r, fn in _fa.KERNELS.items()},
            **{f"flash_attention_bwd_{r}": fn
               for r, fn in _fa.BACKWARD_KERNELS.items()},
            "adamw_sumsq": _aw.adamw_sumsq, "adamw_update": _aw.adamw_update}


def _route(t, name):
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _recorded(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _rmsnorm_direct(x, scale, eps):
    if _route(x, "rmsnorm"):
        if _recorded(x, scale):
            return _rn.RMSNormFunction.apply(x, scale, eps)
        return _rn.rmsnorm(x, scale, eps)
    return _rn.rmsnorm_plain(x, scale, eps)


def _flash_direct(q, k, v, causal, window):
    _fa.check_window(causal, window)
    if _route(q, "flash_attention"):
        if _recorded(q, k, v):
            return _fa.FlashAttentionFunction.apply(q, k, v, causal, window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def _flash_with_lse(q, k, v, causal, window, with_lse):
    """(out, lse) on a plain tensor; lse (B, H, S) where ``with_lse`` (the
    backward kernel reads it), else (B, H, 0)."""
    _fa.check_window(causal, window)
    B, S, H, _ = q.shape
    if _route(q, "flash_attention"):
        lse = q.new_empty((B, H, S if with_lse else 0), dtype=torch.float32)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   lse=lse if with_lse else None), lse
    if with_lse:
        return _fa.flash_attention_plain_lse(q, k, v, causal=causal,
                                             window=window)
    return (_fa.flash_attention_plain(q, k, v, causal=causal, window=window),
            q.new_empty((B, H, 0), dtype=torch.float32))


def _rmsnorm_backward_direct(x, scale, dy, eps):
    if _route(x, "rmsnorm"):
        return _rn.rmsnorm_bwd(x, scale, dy, eps)
    return _rn.rmsnorm_backward(x, scale, dy, eps)


def _flash_backward_direct(q, k, v, out, lse, dy, causal, window):
    """CUDA: the backward kernel of q's dtype; the CPU: the closed form."""
    if _route(q, "flash_attention"):
        kernel = _fa.BACKWARD_KERNELS[_fa.ROUTES[q.dtype]]
        return kernel(q, k, v, out, lse, dy, causal=causal, window=window)
    return _fa.flash_attention_backward(q, k, v, dy, causal, window)


# ---------------------------------------------------------------------------
# The custom ops: what a DTensor or a fake tensor reaches
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    # autograd is the op's own (register_autograd), so the kernel is
    # launched directly here; the output is contiguous, as the fake one
    with torch.no_grad():
        return _rmsnorm_direct(x, scale, eps).contiguous()


@rmsnorm_op.register_fake
def _(x, scale, eps):
    return x.new_empty(x.shape)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _rmsnorm_bwd(ctx, dy):
    x, scale = ctx.saved_tensors
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        # per rank on its rows, as the forward's rule placed them (shards
        # may be uneven: the global shapes are given); the scale's
        # gradient summed over the rows' shards
        mesh = x.device_mesh
        pl = tuple(p if p.is_shard() and p.dim < x.ndim - 1 else Replicate()
                   for p in x.placements)
        x, dy = x.redistribute(mesh, pl), dy.redistribute(mesh, pl)
        scale = scale.redistribute(mesh, (Replicate(),) * mesh.ndim)
        dxl, dsl = rmsnorm_backward_op(x.to_local(), scale.to_local(),
                                       dy.to_local(), ctx.eps)
        dx = DTensor.from_local(dxl, mesh, pl, run_check=False,
                                shape=x.shape, stride=x.stride())
        dscale = DTensor.from_local(
            dsl, mesh, [Partial() if p.is_shard() else p for p in pl],
            run_check=False, shape=scale.shape, stride=scale.stride())
        return dx, dscale, None
    dx, dscale = rmsnorm_backward_op(x, scale, dy, ctx.eps)
    return dx, dscale, None


rmsnorm_op.register_autograd(_rmsnorm_bwd, setup_context=_rmsnorm_setup)


@torch.library.custom_op("repro_torch::rmsnorm_backward", mutates_args=())
def rmsnorm_backward_op(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor,
                        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        return _rmsnorm_backward_direct(x, scale, dy, eps)


@rmsnorm_backward_op.register_fake
def _(x, scale, dy, eps):
    return x.new_empty(x.shape), scale.new_empty(scale.shape)


# ``window`` leads the non-tensor arguments: DTensor's sharding cache keys an
# op's arguments from its first int on (``register_sharding``'s schema
# info), so ``causal`` and ``with_lse``, which set the LSE's shape, are keyed
# too.
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int, causal: bool,
                       with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        out, lse = _flash_with_lse(q, k, v, causal, window, with_lse)
        return out.contiguous(), lse


@flash_attention_op.register_fake
def _(q, k, v, window, causal, with_lse):
    _fa.check_window(causal, window)
    B, S, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, S if with_lse else 0),
                                             dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, window, causal, with_lse = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.window = causal, window


def _lse_placements(pl):
    """q's (B, S, H, hd) placements as the LSE's (B, H, S): heads are its
    dim 1."""
    from torch.distributed.tensor import Shard
    out = []
    for p in pl:
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(f"flash_attention backward: q placed {pl}, not "
                             "by batch or heads")
        out.append(Shard(1) if p.is_shard(2) else p)
    return tuple(out)


def _flash_bwd(ctx, dy, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if is_dtensor(q):
        from torch.distributed.tensor.experimental import local_map
        # q, k, v and the output share their placements (the sharding
        # rule's strategies), the LSE the same on its own dims: each rank's
        # backward is its shard's
        pl = q.placements
        return (*local_map(
            flash_attention_backward_op, out_placements=(pl, pl, pl),
            in_placements=(pl, pl, pl, pl, _lse_placements(pl), pl, None,
                           None),
            device_mesh=q.device_mesh, redistribute_inputs=True)(
                q, k, v, out, lse, dy, ctx.causal, ctx.window), None, None,
            None)
    return (*flash_attention_backward_op(q, k, v, out, lse, dy, ctx.causal,
                                         ctx.window), None, None, None)


flash_attention_op.register_autograd(_flash_bwd, setup_context=_flash_setup)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dy: torch.Tensor, causal: bool,
        window: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        return _flash_backward_direct(q, k, v, out, lse, dy, causal, window)


@flash_attention_backward_op.register_fake
def _(q, k, v, out, lse, dy, causal, window=0):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@functools.cache
def _register_sharding_rules() -> None:
    """The custom ops' DTensor rules, registered when a DTensor first
    reaches them (DTensor's import is deferred: see sharding/specs.py).
    K1: rows are independent, so any dim but the normalized last one may
    be sharded, the scale replicated. K2: batch (dim 0) or heads (dim 2)
    of q, k and v together; heads are only right where each rank's KV
    heads are the groups of its q heads, and ``flash_attention`` takes the
    other GQA case to ``heads_local``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.rmsnorm.default)
    def _rmsnorm_sharding(x, scale, eps):
        out = [([Replicate()], [Replicate(), Replicate(), None])]
        out += [([Shard(d)], [Shard(d), Replicate(), None])
                for d in range(len(x.shape) - 1)]
        return out

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash_sharding(q, k, v, window, causal, with_lse):
        # (out, lse): the LSE (B, H, S) on batch or heads with the output
        return [([Replicate(), Replicate()], [Replicate()] * 3 + [None] * 3),
                ([Shard(0), Shard(0)], [Shard(0)] * 3 + [None] * 3),
                ([Shard(2), Shard(1)], [Shard(2)] * 3 + [None] * 3)]


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _rmsnorm_flop(x_shape, scale_shape, eps, *args, out_shape=None,
                  **kwargs) -> int:
    """Square, sum, scale and the two products: 4 operations an element
    (as the bound of ``chip_smoke.py`` counts them)."""
    n = 1
    for d in x_shape:
        n *= d
    return 4 * n


@register_flop_formula(torch.ops.repro_torch.rmsnorm_backward)
def _rmsnorm_backward_flop(x_shape, *args, out_shape=None, **kwargs) -> int:
    """Two sums (x^2, g x), g, dx's three products and dscale's two: 8
    operations an element (as the backward bound of ``chip_smoke.py``
    counts them)."""
    n = 1
    for d in x_shape:
        n *= d
    return 8 * n


def attention_pairs(S: int, Sk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the attention needs per (batch, head): all
    S*Sk; the S*(S+1)/2 on and below the diagonal when causal; and with a
    causal window, min(q + 1, window) for query q: w(w+1)/2 + (S - w) w
    for a window w < S."""
    if not causal:
        return S * Sk
    if window and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flop(q_shape, k_shape, v_shape, window, causal, *args,
                out_shape=None, **kwargs) -> int:
    """Two products of 2 operations a multiply-add over the pairs the
    attention needs."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * attention_pairs(S, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_backward_flop(q_shape, k_shape, v_shape, out_shape_, lse_shape,
                         dy_shape, causal, window=0, *args, out_shape=None,
                         **kwargs) -> int:
    """Five products (S recomputed, dP, dV, dK, dQ) of 2 operations a
    multiply-add over the pairs the attention needs: 10 hd a pair."""
    B, S, H, hd = q_shape
    return 10 * B * H * hd * attention_pairs(S, k_shape[1], causal, window)


def rmsnorm(x, scale, eps: float = 1e-6):
    if is_wrapped(x):
        if is_dtensor(x):
            _register_sharding_rules()
        return rmsnorm_op(x, scale, eps)
    return _rmsnorm_direct(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd); ``window``:
    a causal sliding window of that many keys (0: none)."""
    if is_dtensor(q):
        _register_sharding_rules()
        lse = _recorded(q, k, v)
        heads = 1
        for i, p in enumerate(q.placements):
            if p.is_shard(2):
                heads *= q.device_mesh.size(i)
        if k.shape[2] % heads:
            # KV heads replicated where q's are sharded: each rank's q heads
            # against the KV heads they read
            return heads_local(lambda ql, kl, vl: flash_attention_op(
                ql, kl, vl, window, causal, lse)[0], q, k, v)
        return flash_attention_op(q, k, v, window, causal, lse)[0]
    if is_wrapped(q):
        return flash_attention_op(q, k, v, window, causal,
                                  _recorded(q, k, v))[0]
    return _flash_direct(q, k, v, causal, window)


def launch_counts() -> dict:
    """Launches by kernel (forward and backward; AdamW's two, a leaf
    each), RMSNorm's by plan too, and ``flash_attention``, both forward
    routes together."""
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

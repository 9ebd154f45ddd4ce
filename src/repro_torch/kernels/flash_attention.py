"""Flash-attention forward for Hopper (CUDA C++), beside its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``). Two kernels, chosen by dtype
(neither is a fallback for the other):

- bf16: ``repro_torch/csrc/flash_attention_sm90.cu``, both products on
  ``wgmma`` tensor cores with K/V tiles fed by TMA. TMA reads q/k/v through
  tensor maps, so each needs a 16-byte aligned base and strides of whole
  16 bytes; other input raises ``ValueError`` (``tma_problem``).
- float32: ``repro_torch/csrc/flash_attention.cu``, scalar fp32 FMAs, which
  keep the float32 model within 1e-4 of the CPU where TF32 would not.

Each source holds the note on what bounds it on the card and how its design
answers that. This module binds both with ctypes (built by
``kernels/build.py``), counts each route's launches, and holds the plain
PyTorch version.

Unlike the Pallas wrapper, K/V may carry fewer heads than Q (GQA: query head
``h`` reads KV head ``h // (H // KV)``, the ``jnp.repeat`` /
``torch.repeat_interleave`` order), S need not divide the tile, and inputs
are read through their strides with no transposes.

``FlashAttentionFunction`` makes the kernels differentiable: its forward
is the launch, its backward the closed-form gradient in torch ops
(``flash_attention_backward``), which recomputes the probabilities from q
and k. The Pallas kernel has no backward kernel either: the JAX package
differentiates the XLA ops of its layers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -1e30
ROUTES = {torch.bfloat16: "bf16", torch.float32: "fp32"}
SUPPORTED_HEAD_DIMS = (32, 64, 112, 128, 256)
TMA_ALIGN = 16          # bytes: TMA's base-address and stride granule
TMA_MAX_STRIDE = 2**40  # bytes


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0.

    Softmax attention scaled by hd**-0.5, in fp32, cast to q's dtype; the
    plain version of the
    kernel, with the kernel's -1e30 mask."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def flash_attention_backward(q, k, v, dy, causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_plain` for the
    upstream gradient ``dy`` (B, S, H, hd). The probabilities P are
    recomputed from q and k at scale hd**-0.5 (with the -1e30 mask), then

        dV = P^T dY,  dS = P * (dY V^T - rowsum(P * dY V^T)),
        dQ = dS K * scale,  dK = dS^T Q * scale

    in fp32 per query head; dK and dV are summed over each KV head's group
    of H // KV query heads and cast back to the inputs' dtypes."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf, kf, vf, df = q.float(), k.float(), v.float(), dy.float()
    if G > 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if G > 1:
        dk = dk.reshape(B, S, KV, G, hd).sum(dim=3)
        dv = dv.reshape(B, S, KV, G, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tma_strides(shape, strides) -> tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, that a tensor map is
    given for a (B, S, heads, hd) operand. A dimension of size 1 is never
    stepped over, so its stride, whatever it is, becomes hd."""
    return tuple(st if n > 1 else shape[3]
                 for n, st in zip(shape[:3], strides[:3]))


def tma_problem(shape, strides, data_ptr: int):
    """Why TMA cannot read a bf16 (B, S, heads, hd) operand with a
    contiguous last dim, these strides (in elements) and this base address,
    or None if it can."""
    if data_ptr % TMA_ALIGN:
        return f"base address {data_ptr:#x} is not {TMA_ALIGN}-byte aligned"
    for dim, st in zip("BSH", tma_strides(shape, strides)):
        nbytes = st * 2  # bytes of a bf16 element
        if nbytes % TMA_ALIGN or not 0 < nbytes < TMA_MAX_STRIDE:
            return (f"stride {st} of dim {dim} is {nbytes} bytes, not a "
                    f"positive multiple of {TMA_ALIGN} below 2**40")
    return None


def kernel_route(dtype, q_shape, q_strides, q_ptr, kv_shape, kv_layouts):
    """The route ("bf16" or "fp32") that launches for these operands;
    raises ValueError or TypeError naming why no kernel takes them.

    ``kv_layouts`` is ``((k_strides, k_ptr), (v_strides, v_ptr))``. A pure
    function of shapes, strides, addresses and dtype."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention kernel supports one dtype of "
                        f"{list(ROUTES)}, got {dtype}")
    if len(q_shape) != 4 or len(kv_shape) != 4:
        raise ValueError(f"bad shapes q{tuple(q_shape)} k/v{tuple(kv_shape)}")
    B, S, H, hd = q_shape
    if kv_shape[0] != B or kv_shape[1] != S or kv_shape[3] != hd \
            or H % kv_shape[2]:
        raise ValueError(f"q{tuple(q_shape)} and k/v{tuple(kv_shape)} must "
                         "share B, S and hd, with H a multiple of KV")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    layouts = [("q", q_shape, q_strides, q_ptr)] + [
        (name, kv_shape, st, ptr) for name, (st, ptr) in zip("kv", kv_layouts)]
    for name, shape, strides, _ in layouts:
        if strides[3] != 1:
            raise ValueError(f"flash_attention kernel needs a contiguous last "
                             f"dim ({name} has stride {strides[3]})")
    route = ROUTES[dtype]
    if route == "bf16":
        for name, shape, strides, ptr in layouts:
            why = tma_problem(shape, strides, ptr)
            if why:
                raise ValueError(f"bf16 flash_attention kernel cannot read "
                                 f"{name} through TMA: {why}")
    return route


@functools.cache
def _lib(name):
    lib = build.load(name)
    fn = getattr(lib, f"repro_{name}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(name, q, k, v, causal, strides):
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib, fn = _lib(name)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, H, k.shape[2], hd, *strides(q), *strides(k), *strides(v),
             *out.stride()[:3], hd ** -0.5, int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.repro_cuda_error_string(err).decode()})")
    return out


def flash_attention_bf16(q, k, v, *, causal: bool = True):
    """The tensor-core kernel; operands already checked by ``kernel_route``."""
    out = _launch("flash_attention_sm90", q, k, v, causal,
                  lambda t: tma_strides(t.shape, t.stride()))
    flash_attention_bf16.launches += 1
    return out


def flash_attention_fp32(q, k, v, *, causal: bool = True):
    """The scalar kernel; operands already checked by ``kernel_route``."""
    out = _launch("flash_attention", q, k, v, causal,
                  lambda t: t.stride()[:3])
    flash_attention_fp32.launches += 1
    return out


flash_attention_bf16.launches = 0
flash_attention_fp32.launches = 0
KERNELS = {"bf16": flash_attention_bf16, "fp32": flash_attention_fp32}


def flash_attention(q, k, v, *, causal: bool = True):
    """Launch the kernel of q's dtype. q: (B, S, H, hd); k, v: (B, S, KV, hd),
    on one CUDA device."""
    if not (q.device.type == k.device.type == v.device.type == "cuda") \
            or not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k{tuple(k.shape)} and v{tuple(v.shape)} differ")
    route = kernel_route(q.dtype, q.shape, q.stride(), q.data_ptr(), k.shape,
                         ((k.stride(), k.data_ptr()),
                          (v.stride(), v.data_ptr())))
    return KERNELS[route](q, k, v, causal=causal)


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel of q's dtype under autograd: the forward launches it (and
    counts the launch), the backward is :func:`flash_attention_backward`
    on the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dy):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, dy, ctx.causal), None)

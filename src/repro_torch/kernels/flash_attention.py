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

``FlashAttentionFunction`` makes the kernels differentiable. bf16: the
forward launch also writes each row's log-sum-exp, and the backward
launches ``csrc/flash_attention_bwd_sm90.cu`` (``flash_attention_bwd_bf16``:
dK and dV per key tile, dQ per query tile, every product on ``wgmma``, P
recomputed per tile from that LSE).
float32: the backward is the closed form in torch ops, chosen by dtype as
the forward's routes are (K2's fp32 route has no backward kernel). The
closed form, ``flash_attention_backward``, is the bf16 backward kernel's
plain version too: the CPU takes it, a bf16 CUDA tensor never does. The
Pallas kernel has no backward: the JAX package differentiates the XLA ops
of its layers.
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
# the bf16 backward's tiles (csrc/flash_attention_bwd_sm90.cu): the main
# kernel's keys a block and queries a step, the dQ kernel's rows a block
# and keys a step
BWD_BLOCK_K, BWD_BLOCK_Q = 128, 64
BWD_DQ_ROWS, BWD_DQ_KEYS = 128, 64


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


def flash_attention_plain_lse(q, k, v, *, causal: bool = True):
    """:func:`flash_attention_plain` and the row log-sum-exp of its scaled,
    masked scores, fp32 (B, H, S): what the bf16 kernel writes for the
    backward, in its plain version."""
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
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
    return out, lse


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


# the forward entries' arguments; the bf16 one also takes the LSE pointer
_FWD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int])
_ARGTYPES = {
    "flash_attention": _FWD_ARGS + [ctypes.c_void_p],
    "flash_attention_sm90": _FWD_ARGS + [ctypes.c_void_p] * 2,
    "flash_attention_bwd_sm90": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                                 + [ctypes.c_int64] * 24
                                 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])}


@functools.cache
def _lib(name):
    lib = build.load(name)
    fn = getattr(lib, f"repro_{name}" if name.startswith(
        "flash_attention_bwd") else f"repro_{name}_fwd")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.repro_cuda_error_string(err).decode()})")


def _launch(name, q, k, v, causal, strides, *extra):
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib, fn = _lib(name)
    _check(lib, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, H, k.shape[2], hd, *strides(q), *strides(k),
                   *strides(v), *out.stride()[:3], hd ** -0.5,
                   int(bool(causal)), *extra,
                   torch.cuda.current_stream(q.device).cuda_stream), name)
    return out


def _tma(t):
    return tma_strides(t.shape, t.stride())


def flash_attention_bf16(q, k, v, *, causal: bool = True, lse=None):
    """The tensor-core kernel; operands already checked by ``kernel_route``.
    ``lse``: None, or a contiguous fp32 (B, H, S) the kernel fills with each
    row's log-sum-exp, for the backward."""
    out = _launch("flash_attention_sm90", q, k, v, causal, _tma,
                  None if lse is None else lse.data_ptr())
    flash_attention_bf16.launches += 1
    return out


def flash_attention_fp32(q, k, v, *, causal: bool = True):
    """The scalar kernel; operands already checked by ``kernel_route``."""
    out = _launch("flash_attention", q, k, v, causal,
                  lambda t: t.stride()[:3])
    flash_attention_fp32.launches += 1
    return out


def backward_grids(B: int, S: int, H: int, KV: int):
    """The bf16 backward's grids: the main kernel's, one block per
    (BWD_BLOCK_K-key tile, KV head's share of query heads, batch), and the
    dQ kernel's, one per (BWD_DQ_ROWS-query tile, head, batch). A pure
    function."""
    return ((-(-S // BWD_BLOCK_K), KV * backward_splits(H, KV), B),
            (-(-S // BWD_DQ_ROWS), H, B))


def backward_splits(H: int, KV: int) -> int:
    """Blocks a KV head's query heads are split over in the backward's main
    kernel: one a query head where G = H / KV > 1 (each writes fp32 dK and
    dV partials, summed per KV head by a small launch), else 1."""
    return H // KV


def backward_smem_bytes(hd: int, dq: bool = False) -> int:
    """Dynamic shared memory a block of the backward's main kernel (or,
    ``dq``, of its dQ kernel) takes, as ``Tile<HD>::SMEM`` /
    ``DqTile<HD>::SMEM`` of the source: main, K and V tiles of BWD_BLOCK_K
    rows and a ring of Q and dO tiles of BWD_BLOCK_Q rows with their LSE
    and delta rows; dQ, Q and dO tiles of BWD_DQ_ROWS rows and a ring of K
    and V tiles of BWD_DQ_KEYS rows; 1 ring stage at hd 256, else 2; the
    mbarriers and 1024 bytes of alignment. A pure function."""
    tile = 128 if hd == 112 else hd
    stages = 1 if tile == 256 else 2
    row = 128 if tile >= 64 else 64          # bytes of a swizzled row
    blocks = tile * 2 // row
    if dq:
        return (1024 + 2 * blocks * BWD_DQ_ROWS * row
                + 2 * stages * blocks * BWD_DQ_KEYS * row + 8 * (1 + 4 * stages))
    return (1024 + 2 * blocks * BWD_BLOCK_K * row
            + 2 * stages * blocks * BWD_BLOCK_Q * row
            + 2 * stages * BWD_BLOCK_Q * 4 + 8 * (1 + 2 * stages))


def backward_padded_rows(S: int) -> int:
    """S rounded up to whole BWD_BLOCK_Q tiles: the row length of the
    backward's LSE and delta scratch."""
    return -(-S // BWD_BLOCK_Q) * BWD_BLOCK_Q


def flash_attention_bwd_bf16(q, k, v, out, lse, dy, *, causal: bool = True):
    """The bf16 backward kernel: ``(dq, dk, dv)`` of the forward that gave
    ``out`` and ``lse`` (fp32 (B, H, S)), for the upstream gradient ``dy``,
    as :func:`flash_attention_backward` computes them. q, k, v: the
    forward's operands; dy is read through its strides where TMA can (a
    contiguous copy otherwise). Raises for what the kernel does not take.
    Counts one launch."""
    if not (q.is_cuda and k.device == q.device == v.device == out.device
            == lse.device == dy.device):
        raise ValueError("flash_attention backward kernel needs CUDA tensors "
                         "on one device")
    if not q.dtype == k.dtype == v.dtype == out.dtype == dy.dtype \
            == torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention backward kernel takes bf16 q, k, v, "
                        f"out, dy and an fp32 lse, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {out.dtype}, {dy.dtype}, {lse.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    kernel_route(q.dtype, q.shape, q.stride(), q.data_ptr(), k.shape,
                 ((k.stride(), k.data_ptr()), (v.stride(), v.data_ptr())))
    if out.shape != q.shape or dy.shape != q.shape \
            or lse.shape != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"out{tuple(out.shape)}, dy{tuple(dy.shape)} and "
                         f"lse{tuple(lse.shape)} do not fit q{tuple(q.shape)}")
    if out.stride(3) != 1 or tma_problem(out.shape, out.stride(),
                                         out.data_ptr()):
        raise ValueError("flash_attention backward kernel reads out in "
                         "16-byte aligned rows, as TMA would")
    if dy.stride(3) != 1 or tma_problem(dy.shape, dy.stride(), dy.data_ptr()):
        dy = dy.contiguous()
    S_pad = backward_padded_rows(S)
    vecs = torch.empty((2, B * H * S_pad), dtype=torch.float32,
                       device=q.device)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    splits = backward_splits(H, KV)
    part = torch.empty((2, B, S, KV * splits, hd), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    lib, fn = _lib("flash_attention_bwd_sm90")
    _check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dy.data_ptr(), lse.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(),
        B, S, H, KV, hd, splits, *_tma(q), *_tma(k), *_tma(v), *_tma(out), *_tma(dy),
        *_tma(dq), *_tma(dk), *_tma(dv), hd ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd_sm90")
    flash_attention_bwd_bf16.launches += 1
    return dq, dk, dv


flash_attention_bf16.launches = 0
flash_attention_fp32.launches = 0
flash_attention_bwd_bf16.launches = 0
KERNELS = {"bf16": flash_attention_bf16, "fp32": flash_attention_fp32}


def flash_attention(q, k, v, *, causal: bool = True, lse=None):
    """Launch the kernel of q's dtype. q: (B, S, H, hd); k, v: (B, S, KV, hd),
    on one CUDA device. ``lse``: a contiguous fp32 (B, H, S) for the bf16
    kernel to fill with each row's log-sum-exp (the fp32 route writes
    none)."""
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
    if lse is None:
        return KERNELS[route](q, k, v, causal=causal)
    B, S, H, _ = q.shape
    if route != "bf16" or lse.dtype != torch.float32 \
            or lse.shape != (B, H, S) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"only the bf16 kernel writes a log-sum-exp, into a "
                         f"contiguous fp32 ({B}, {H}, {S}) on q's device")
    return flash_attention_bf16(q, k, v, causal=causal, lse=lse)


def new_lse(q):
    """The (B, H, S) fp32 tensor the bf16 forward writes its LSE into."""
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel of q's dtype under autograd, each direction launched and
    counted. bf16: the forward also writes the LSE, and the backward is
    :func:`flash_attention_bwd_bf16` on the saved q, k, v, output and LSE.
    float32: the backward is :func:`flash_attention_backward` on q, k and
    v (the fp32 route has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        if ROUTES.get(q.dtype) != "bf16":
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, causal=causal)
        lse = new_lse(q)
        out = flash_attention(q, k, v, causal=causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            return (*flash_attention_backward(*saved, dy, ctx.causal), None)
        return (*flash_attention_bwd_bf16(*saved, dy, causal=ctx.causal),
                None)

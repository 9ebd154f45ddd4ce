"""Fused RMSNorm for Hopper (CUDA C++), beside its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm``): Gemma-style
``y = x * rsqrt(mean(x^2, -1) + eps) * (1 + scale)``, computed in fp32 and
cast back to ``x.dtype``.

The kernel is ``repro_torch/csrc/rmsnorm.cu`` (built by ``kernels/build.py``
and bound here with ctypes); its header says what bounds it and how each of
its two launch plans answers that. ``plan`` picks the plan from the row
count: ``rows`` (one block per row) for the few rows of a decode step,
``ring`` (a persistent grid fed by TMA bulk copies) for prefill. Both read
rows in 16-byte chunks, so x's base, its row stride and a row's bytes must
be multiples of 16 (``check_bulk_copy``); other input raises ``ValueError``.

``RMSNormFunction`` makes the kernel differentiable: its forward is the
kernel launch, its backward the backward kernel of the same source
(``rmsnorm_bwd``: one pass a row for dx and a per-block dscale partial,
then a column sum of the partials; plan ``backward_plan``). The closed
form in torch ops, ``rmsnorm_backward``, is that kernel's plain version:
the CPU takes it, and a CUDA tensor never does. The Pallas kernel has no
backward: the JAX package differentiates the XLA ops of its layers.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
ALIGN = 16                   # bytes: a chunk, and the bulk copy's granule
MAX_THREADS = 1024           # a block's
SM_THREADS = 2048            # an SM's (the rows kernel fits 32 registers)
SM_BLOCKS = 32               # resident blocks an SM holds at most
VEC = 2                      # chunks of a row per thread, at most
SMEM_LIMIT = 232_448         # bytes of shared memory a block may use (227 KB)
RED_BYTES = 2 * 32 * 4       # the ring's two buffers of per-warp sums
RING_BYTES_PER_SM = 128 * 1024  # rows in flight on an SM, in all its blocks

BWD_BLOCK_THREADS = 512     # a backward block's threads, all its row slots
BWD_SM_THREADS = 1024       # the backward takes up to 64 registers a thread
BWD_RED_BYTES = 4 * 32 * 4  # its two buffers of per-warp (sum x^2, sum g x)

Plan = collections.namedtuple("Plan", "name grid threads stages smem")
BwdPlan = collections.namedtuple("BwdPlan", "grid threads slots smem")


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,). The plain version of the kernel."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_backward(x, scale, dy, eps: float = 1e-6):
    """Gradients ``(dx, dscale)`` of ``y = x * r * (1 + scale)``, where
    ``r = rsqrt(mean(x^2, -1) + eps)``, for the upstream gradient ``dy``:

        dx     = r * (g - xhat * mean(g * xhat, -1)),  g = dy * (1 + scale)
        dscale = sum over rows of dy * xhat,           xhat = x * r

    computed in fp32 and cast back to x's and scale's dtypes, as the
    forward computes in fp32 and casts back."""
    xf, df = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    g = df * (1.0 + scale.float())
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (df * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _threads(D: int, element_size: int) -> int:
    """Threads a block for rows of D elements: a warp for each 64 chunks
    (two per thread), at most 1024; raises if a row needs more."""
    chunks = D * element_size // ALIGN
    threads = min(MAX_THREADS, 32 * -(-chunks // (32 * VEC)))
    if chunks > VEC * threads:
        raise ValueError(f"rmsnorm kernel takes rows of at most "
                         f"{VEC * MAX_THREADS * ALIGN} bytes, got {D} "
                         f"elements of {element_size} bytes")
    return threads


def blocks_per_sm(threads: int) -> int:
    return min(SM_BLOCKS, SM_THREADS // threads)


def rows_plan(rows: int, D: int, element_size: int) -> Plan:
    """One block per row, no shared-memory ring."""
    return Plan("rows", rows, _threads(D, element_size), 0, 0)


def ring_plan(rows: int, D: int, element_size: int, n_sm: int) -> Plan:
    """A persistent grid of at most ``n_sm`` x k blocks, each walking rows
    through a ring of 2-4 stages of one row each. k is half the blocks an
    SM holds (the ring kernel takes up to 64 registers a thread, so 1024
    threads an SM); the stages share ``RING_BYTES_PER_SM`` among an SM's k
    blocks. The grid never exceeds the rows, so every block has at least
    one."""
    threads = _threads(D, element_size)
    row_bytes = D * element_size
    k = max(1, blocks_per_sm(threads) // 2)
    stages = max(2, min(4, RING_BYTES_PER_SM // (k * row_bytes)))
    smem = stages * row_bytes + RED_BYTES + 8 * stages
    if smem > SMEM_LIMIT:
        raise ValueError(f"rmsnorm ring of {stages} rows of {row_bytes} "
                         f"bytes needs {smem} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    return Plan("ring", min(rows, n_sm * k), threads, stages, smem)


@functools.lru_cache(maxsize=256)
def plan(rows: int, D: int, dtype: torch.dtype, n_sm: int) -> Plan:
    """The launch plan for ``rows`` rows of D elements of ``dtype`` on a
    card of ``n_sm`` SMs: ``rows`` while one block per row fits the card in
    one wave, ``ring`` above. A pure function."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"rmsnorm kernel supports {SUPPORTED_DTYPES}, "
                        f"got {dtype}")
    if rows < 1 or D < 1 or n_sm < 1:
        raise ValueError(f"no plan for rows={rows}, D={D}, n_sm={n_sm}")
    element_size = dtype.itemsize
    if rows <= n_sm * blocks_per_sm(_threads(D, element_size)):
        return rows_plan(rows, D, element_size)
    return ring_plan(rows, D, element_size, n_sm)


@functools.lru_cache(maxsize=256)
def backward_plan(rows: int, D: int, dtype: torch.dtype, n_sm: int) -> BwdPlan:
    """The backward's launch for ``rows`` rows of D elements of ``dtype`` on
    ``n_sm`` SMs. A row takes the threads a forward row does (``tr``); a
    block holds ``slots`` rows at a time, up to ``BWD_BLOCK_THREADS``
    threads; the grid is the blocks the card holds at once
    (``BWD_SM_THREADS`` an SM), never more than the rows need, so every
    block has a row. Each block writes one fp32 row of dscale partials,
    summing its slots through ``slots * D * 4`` bytes of shared memory
    beside the warps' sums. A pure function."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"rmsnorm kernel supports {SUPPORTED_DTYPES}, "
                        f"got {dtype}")
    if rows < 1 or D < 1 or n_sm < 1:
        raise ValueError(f"no plan for rows={rows}, D={D}, n_sm={n_sm}")
    tr = _threads(D, dtype.itemsize)
    slots = max(1, min(BWD_BLOCK_THREADS // tr, rows))
    threads = slots * tr
    grid = min(n_sm * max(1, BWD_SM_THREADS // threads), -(-rows // slots))
    smem = BWD_RED_BYTES + (slots * D * 4 if slots > 1 else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"rmsnorm backward of {slots} rows of {D} needs "
                         f"{smem} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    return BwdPlan(grid, threads, slots, smem)


def check_bulk_copy(rows: int, D: int, element_size: int, row_stride: int,
                    data_ptr: int) -> None:
    """Raise ``ValueError`` naming the rule that ``rows`` rows of D elements
    at ``data_ptr``, ``row_stride`` elements apart, break: the kernel copies
    a row as one bulk copy and reads it in 16-byte chunks. A single row has
    no stride to check. A pure function."""
    if data_ptr % ALIGN:
        raise ValueError(f"rmsnorm kernel needs a {ALIGN}-byte aligned base, "
                         f"got {data_ptr:#x}")
    if D * element_size % ALIGN:
        raise ValueError(f"rmsnorm kernel needs rows of a multiple of "
                         f"{ALIGN} bytes, got D={D} x {element_size} bytes")
    if rows > 1 and row_stride * element_size % ALIGN:
        raise ValueError(f"rmsnorm kernel needs a row stride of a multiple "
                         f"of {ALIGN} bytes, got {row_stride} elements x "
                         f"{element_size} bytes")


def as_rows(x):
    """x (..., D) as the (rows, D) tensor the kernel reads: a view where
    ``reshape`` gives one, with any row stride; a copy only if the last dim
    is not contiguous."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


class LaunchArgs(ctypes.Structure):
    """``RmsnormArgs`` of ``csrc/rmsnorm.cu``: what a launch takes besides
    the pointers and the stream, built once per plan and shape."""
    _fields_ = [("rows", ctypes.c_int), ("D", ctypes.c_int),
                ("sx", ctypes.c_int64), ("eps", ctypes.c_float),
                ("bf16", ctypes.c_int),
                ("ring", ctypes.c_int), ("grid", ctypes.c_int),
                ("threads", ctypes.c_int), ("stages", ctypes.c_int),
                ("smem", ctypes.c_int)]


class BackwardArgs(ctypes.Structure):
    """``RmsnormBwdArgs`` of ``csrc/rmsnorm.cu``."""
    _fields_ = [("rows", ctypes.c_int), ("D", ctypes.c_int),
                ("sx", ctypes.c_int64), ("sdy", ctypes.c_int64),
                ("eps", ctypes.c_float), ("bf16", ctypes.c_int),
                ("grid", ctypes.c_int), ("threads", ctypes.c_int),
                ("slots", ctypes.c_int), ("smem", ctypes.c_int)]


@functools.lru_cache(maxsize=256)
def _launch_args(p: Plan, rows: int, D: int, row_stride: int, eps: float,
                 bf16: bool):
    """The launch's ``LaunchArgs``, by reference (one ctypes argument in
    place of ten)."""
    return ctypes.byref(LaunchArgs(rows, D, row_stride, eps, bf16,
                                   p.name == "ring", p.grid, p.threads,
                                   p.stages, p.smem))


@functools.cache
def _lib():
    lib = build.load("rmsnorm")
    lib.repro_rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(LaunchArgs), ctypes.c_void_p]
    lib.repro_rmsnorm_fwd.restype = ctypes.c_int
    lib.repro_rmsnorm_bwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.POINTER(BackwardArgs), ctypes.c_void_p]
    lib.repro_rmsnorm_bwd.restype = ctypes.c_int
    lib.repro_rmsnorm_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.repro_rmsnorm_empty.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_lib().repro_cuda_error_string(err).decode()})")


def launch(x, scale, eps: float, p: Plan, row_stride: int | None = None):
    """Launch plan ``p`` on checked CUDA input: x (..., D), contiguous, or
    (rows, D) rows ``row_stride`` elements apart; returns y, contiguous, of
    x's shape. Counts the launch, in all, for the plan and by row count."""
    D = x.shape[-1]
    rows = x.numel() // D
    # contiguous: x is contiguous or, as a (rows, D) view with a padded
    # row stride, not dense
    out = torch.empty_like(x)
    dev = x.get_device()
    _raise_on(_lib().repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _launch_args(p, rows, D, D if row_stride is None else row_stride,
                     eps, x.dtype == torch.bfloat16),
        # the current stream's handle, without building a Stream object
        torch._C._cuda_getCurrentRawStream(dev)), "rmsnorm launch")
    rmsnorm.launches += 1
    rmsnorm.plan_launches[p.name] += 1
    rmsnorm.row_launches[rows] += 1
    return out


def rmsnorm(x, scale, eps: float = 1e-6):
    """Launch the kernel. x: (..., D) on CUDA; scale: (D,) -> x's shape."""
    if not x.is_cuda or scale.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {scale.device}")
    if x.dtype not in SUPPORTED_DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel supports x and scale of one dtype "
                        f"of {SUPPORTED_DTYPES}, got {x.dtype} and "
                        f"{scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    if x.numel() == 0:
        return torch.empty_like(x)
    # a contiguous x is read as it is; anything else as its (rows, D) view
    x2 = x if x.is_contiguous() else as_rows(x)
    rows = x2.numel() // D
    row_stride = D if x2 is x else x2.stride(0)
    scale = scale.contiguous()
    check_bulk_copy(rows, D, x.element_size(), row_stride, x2.data_ptr())
    check_bulk_copy(1, D, x.element_size(), D, scale.data_ptr())
    p = plan(rows, D, x.dtype, sm_count(x.get_device()))
    out = launch(x2, scale, eps, p, row_stride)
    return out if x2 is x else out.view(x.shape)


rmsnorm.launches = 0
rmsnorm.plan_launches = {"rows": 0, "ring": 0}
rmsnorm.row_launches = collections.Counter()  # launches by row count


def _readable_rows(t):
    """t (..., D) as (rows, D) rows the kernel can read in 16-byte chunks:
    the ``as_rows`` view where its base and row stride allow, else a
    contiguous copy."""
    t2 = as_rows(t)
    rows, D = t2.shape
    if t2.data_ptr() % ALIGN or (rows > 1 and t2.stride(0)
                                 * t2.element_size() % ALIGN):
        t2 = t2.contiguous()
    return t2


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """Launch the backward kernel: ``(dx, dscale)`` of :func:`rmsnorm` for
    the upstream gradient ``dy``, as :func:`rmsnorm_backward` computes
    them. x, dy: (..., D) on CUDA; scale: (D,). dy is read through its row
    stride (copied only if its rows are off the 16-byte grain). Counts one
    launch."""
    if not x.is_cuda or scale.get_device() != x.get_device() \
            or dy.get_device() != x.get_device():
        raise ValueError(f"rmsnorm backward kernel needs CUDA tensors on one "
                         f"device, got {x.device}, {scale.device} and "
                         f"{dy.device}")
    if x.dtype not in SUPPORTED_DTYPES or not x.dtype == scale.dtype \
            == dy.dtype:
        raise TypeError(f"rmsnorm backward kernel supports x, scale and dy "
                        f"of one dtype of {SUPPORTED_DTYPES}, got {x.dtype}, "
                        f"{scale.dtype} and {dy.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,) or dy.shape != x.shape:
        raise ValueError(f"shapes x{tuple(x.shape)}, scale"
                         f"{tuple(scale.shape)}, dy{tuple(dy.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(scale)
    x2 = as_rows(x)
    dy2 = _readable_rows(dy)
    rows = x2.shape[0]
    scale = scale.contiguous()
    check_bulk_copy(rows, D, x.element_size(), x2.stride(0), x2.data_ptr())
    check_bulk_copy(1, D, x.element_size(), D, scale.data_ptr())
    dev = x.get_device()
    p = backward_plan(rows, D, x.dtype, sm_count(dev))
    dx = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    partial = torch.empty((p.grid, D), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    args = BackwardArgs(rows, D, x2.stride(0), dy2.stride(0), eps,
                        x.dtype == torch.bfloat16, *p)
    _raise_on(_lib().repro_rmsnorm_bwd(
        x2.data_ptr(), scale.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), ctypes.byref(args),
        torch._C._cuda_getCurrentRawStream(dev)), "rmsnorm backward launch")
    rmsnorm_bwd.launches += 1
    return dx.view(x.shape), dscale


rmsnorm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """The kernel under autograd: the forward launches it, the backward
    launches :func:`rmsnorm_bwd` on the saved inputs (each counts its
    launch)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def empty_launch(blocks: int, threads: int):
    """Launch the library's empty kernel of ``blocks`` x ``threads`` on the
    current device's current stream: the floor under any launch of that
    grid."""
    _raise_on(_lib().repro_rmsnorm_empty(
        blocks, threads,
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())),
        "empty kernel launch")

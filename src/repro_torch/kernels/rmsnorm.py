"""Fused RMSNorm for Hopper, in Triton, beside its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm``): Gemma-style
``y = x * rsqrt(mean(x^2, -1) + eps) * (1 + scale)``, computed in fp32 and
cast back to ``x.dtype``.

What bounds it on an H100: it does a few operations per element and moves
``2 * rows * D`` elements (one read of x, one write of y), so it is bound by
device-memory bytes (3.35 TB/s on the SXM part). The design reads each row
once: one Triton program holds one whole row (D padded to a power of two
and masked) in registers, reduces the sum of squares in fp32, and writes
the scaled row, so the three passes of the plain version (square-mean,
normalise, scale) become one read and one write.

``triton`` is imported inside the launching function: the module imports
on machines without it. (No ``from __future__ import annotations`` here:
Triton reads the ``tl.constexpr`` annotation of the kernel.)
"""
import functools
import os

import torch

from .build import BUILD_DIR

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,). The plain version of the kernel."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


@functools.cache
def _kernel():
    # Triton keeps its cache under TRITON_HOME; keep it inside the checkout.
    os.environ.setdefault("TRITON_HOME", str(BUILD_DIR / "triton"))
    # Triton resolves names through the kernel's globals, so ``tl`` is bound
    # as a module global here rather than as a local of this function.
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, D, stride_x, stride_o, eps,
                       BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        y = x * tl.rsqrt(var + eps)
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = y * (1.0 + s)
        tl.store(o_ptr + row * stride_o + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel


def rmsnorm(x, scale, eps: float = 1e-6):
    """Launch the kernel. x: (..., D) on CUDA; scale: (D,) -> x's shape."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {scale.device}")
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"rmsnorm kernel supports {SUPPORTED_DTYPES}, got {x.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    scale = scale.contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows:
        block = 1 << (D - 1).bit_length()      # D padded to a power of two
        _kernel()[(rows,)](x2, scale, out, D, x2.stride(0), out.stride(0),
                           eps, BLOCK_D=block,
                           num_warps=8 if block >= 4096 else 4)
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0

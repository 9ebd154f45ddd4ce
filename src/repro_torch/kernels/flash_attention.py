"""Flash-attention forward for Hopper (CUDA C++), beside its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``). The kernel itself, with the note
on what bounds it on the card and how its design answers that, is
``repro_torch/csrc/flash_attention.cu``; this module binds it with ctypes
(built by ``kernels/build.py``) and holds the plain PyTorch version.

Unlike the Pallas wrapper, K/V may carry fewer heads than Q (GQA: query head
``h`` reads KV head ``h // (H // KV)``, the ``jnp.repeat`` /
``torch.repeat_interleave`` order), S need not divide the tile, and inputs
are read through their strides with no transposes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -1e30
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)


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


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    if not (q.device.type == k.device.type == v.device.type == "cuda") \
            or not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in SUPPORTED_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel supports one dtype of "
                        f"{list(SUPPORTED_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd \
            or H % k.shape[2]:
        raise ValueError(f"q{tuple(q.shape)} and k/v{tuple(k.shape)} must "
                         "share B, S and hd, with H a multiple of KV")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention kernel needs a contiguous last dim")


def flash_attention(q, k, v, *, causal: bool = True):
    """Launch the kernel. q: (B, S, H, hd); k, v: (B, S, KV, hd), on CUDA."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        SUPPORTED_DTYPES[q.dtype], B, S, H, k.shape[2], hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        hd ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.repro_cuda_error_string(err).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""Time K2's forward and backward on the card, both routes, at the serving
and training paths' shapes.

    python -m repro_torch.launch.kernel_times [label]

prints one JSON line: the label, the mean ms of one forward call
(``kernels.flash_attention.flash_attention``) at each bf16 shape of
``SHAPES`` and fp32 shape of ``FP32_SHAPES``, and of one backward call
(``flash_attention_bwd_bf16`` / ``flash_attention_bwd_fp32``, from the
forward's LSE) at each of ``BWD_SHAPES`` / ``FP32_BWD_SHAPES``, by CUDA
events with the L2 flushed before each call, as ``chip_smoke.py``'s
``time_ms`` times it; beside each fp32 shape, one call of PyTorch's
``scaled_dot_product_attention`` on the same inputs (its backward through
autograd), the yardstick, and the least time an H100 SXM could take
(``fp32_bound_ms``: the larger of the bytes over 3.35 TB/s and the
operations over 165 TFLOP/s, 3xTF32's rate, a third of TF32's 495; and
the operations alone at the 67 TFLOP/s of scalar FMAs, ``fp32_fma_ms``).
To compare two trees on one card, run this file
against each tree's package in turns (parent, change, change, parent,
...), each from the root of its tree:

    PYTHONPATH=src python <path to this file> parent

The file imports only the package it finds and calls entry points every
tree of the port has, so the same file times a tree that does not have
it. It runs on the card only.
"""
from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

# (B, S, H, KV, hd, causal): kimi-k2's hd 112, whisper's encoder,
# command-r's and yi-9b's long prefill, yi-9b's short prefill, gemma3-12b's
# global layers at hd 256, qwen2-vl's 1024 patches + 256 tokens
SHAPES = ((1, 4096, 64, 8, 112, True), (4, 1500, 16, 16, 64, False),
          (1, 4096, 64, 8, 128, True), (1, 4096, 32, 4, 128, True),
          (4, 256, 32, 4, 128, True), (1, 2048, 16, 8, 256, True),
          (4, 1280, 12, 2, 128, True))
# the backward's (B, S, H, KV, hd), causal: gpt's and yi-9b's training steps
BWD_SHAPES = ((8, 1024, 12, 12, 64), (1, 4096, 32, 4, 128))
# the fp32 route, causal, (B, S, H, KV, hd, window): launch.train's reduced
# default, yi-9b's short and long prefill, kimi-k2's hd 112, gemma3-12b's
# local layers with their window
FP32_SHAPES = ((4, 128, 4, 2, 32, 0), (4, 256, 32, 4, 128, 0),
               (1, 4096, 32, 4, 128, 0), (1, 4096, 64, 8, 112, 0),
               (1, 4096, 16, 8, 256, 1024))
# its backward, causal: launch.train's, the gpt gradient check's, yi-9b's
FP32_BWD_SHAPES = ((4, 128, 4, 2, 32), (2, 1024, 12, 12, 64),
                   (1, 4096, 32, 4, 128))
CALLS = 30
# H100 SXM data sheet: bytes/s of device memory, 3xTF32 and scalar fp32
# operations/s
HBM, TF32X3, FMA = 3.35e12, 495e12 / 3, 67e12


def causal_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask lets through, with a sliding window
    of ``window`` keys (0: none)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def fp32_bounds(B, S, H, KV, hd, window=0, backward=False):
    """(bound ms, "bytes" or "operations", ms at the FMA rate) of one fp32
    call: each input read and output written once; 4 hd operations a
    visited pair forward, 10 hd backward (five products)."""
    pairs = B * H * causal_pairs(S, window)
    if backward:   # q, k, v, out, dy, lse in; dq, dk, dv out
        nbytes = 4 * (B * S * hd * (4 * H + 4 * KV) + B * H * S)
        nops = 10 * hd * pairs
    else:
        nbytes = 4 * 2 * B * S * hd * (H + KV)
        nops = 4 * hd * pairs
    t_bytes, t_ops = nbytes / HBM * 1e3, nops / TF32X3 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, nops / FMA * 1e3))


def time_ms(fn, calls: int, flush) -> float:
    """Mean device ms of ``fn``: CUDA events around each call, the L2
    flushed and a ~1 ms device sleep queued before it (so the call's
    launches are enqueued before the card reaches them)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / calls


def _inputs(B, S, H, KV, hd, dtype, names=("q", "k", "v")):
    g = torch.Generator(device="cuda").manual_seed(0)
    n = {"q": H, "k": KV, "v": KV, "dy": H}
    return [torch.randn(B, S, n[x], hd, generator=g, device="cuda").to(dtype)
            for x in names]


def _sdpa(q, k, v, window):
    """SDPA on (B, S, heads, hd) tensors, causal, with the boolean window
    mask where there is a window."""
    from repro_torch.kernels import flash_attention as fa
    S = q.shape[1]
    mask = fa.key_mask(S, S, True, window, q.device) if window else None
    return F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), attn_mask=mask,
        is_causal=not window, enable_gqa=True)


def main(argv=None) -> int:
    from repro_torch.kernels import flash_attention as fa
    label = (argv if argv is not None else sys.argv[1:] or ["k2"])[0]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this times the card's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    key = "{}x{} {}/{} hd{}".format
    out = {}
    for B, S, H, KV, hd, causal in SHAPES:
        q, k, v = _inputs(B, S, H, KV, hd, torch.bfloat16)
        out[key(B, S, H, KV, hd)] = time_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal), CALLS, flush)
    bwd = {}
    for B, S, H, KV, hd in BWD_SHAPES:
        q, k, v, dy = _inputs(B, S, H, KV, hd, torch.bfloat16,
                              ("q", "k", "v", "dy"))
        lse = fa.new_lse(q)
        o = fa.flash_attention(q, k, v, causal=True, lse=lse)
        bwd[key(B, S, H, KV, hd)] = time_ms(
            lambda: fa.flash_attention_bwd_bf16(q, k, v, o, lse, dy,
                                                causal=True), CALLS, flush)
    fp32, fp32_bwd, sdpa, sdpa_bwd, bounds = {}, {}, {}, {}, {}
    for B, S, H, KV, hd, window in FP32_SHAPES:
        q, k, v = _inputs(B, S, H, KV, hd, torch.float32)
        name = key(B, S, H, KV, hd) + (f" window {window}" if window else "")
        fp32[name] = time_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), CALLS, flush)
        sdpa[name] = time_ms(lambda: _sdpa(q, k, v, window), CALLS, flush)
        bounds[name] = fp32_bounds(B, S, H, KV, hd, window)
    for B, S, H, KV, hd in FP32_BWD_SHAPES:
        q, k, v, dy = _inputs(B, S, H, KV, hd, torch.float32,
                              ("q", "k", "v", "dy"))
        lse = fa.new_lse(q)
        o = fa.flash_attention(q, k, v, causal=True, lse=lse)
        name = key(B, S, H, KV, hd)
        bounds[f"backward {name}"] = fp32_bounds(B, S, H, KV, hd,
                                                 backward=True)
        fp32_bwd[name] = time_ms(
            lambda: fa.flash_attention_bwd_fp32(q, k, v, o, lse, dy,
                                                causal=True), CALLS, flush)
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        y = _sdpa(*xs, 0)
        dyt = dy.transpose(1, 2)
        sdpa_bwd[name] = time_ms(lambda: torch.autograd.grad(
            y, xs, dyt, retain_graph=True), CALLS, flush)
    print(json.dumps({"label": label, "ms": out, "backward_ms": bwd,
                      "fp32_ms": fp32, "fp32_sdpa_ms": sdpa,
                      "fp32_backward_ms": fp32_bwd,
                      "fp32_sdpa_backward_ms": sdpa_bwd,
                      "fp32_bound_ms": bounds,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

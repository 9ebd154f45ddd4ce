"""Time K2's bf16 forward and backward on the card at the serving and
training paths' shapes.

    python -m repro_torch.launch.kernel_times [label]

prints one JSON line: the label, the mean ms of one forward call
(``kernels.flash_attention.flash_attention``) at each shape of
``SHAPES`` and of one backward call (``flash_attention_bwd_bf16``, from
the forward's LSE) at each of ``BWD_SHAPES``, by CUDA events with the
L2 flushed before each call, as
``chip_smoke.py``'s ``time_ms`` times it. To compare two trees on one
card, run this file against each tree's package in turns (parent,
change, change, parent, ...), each from the root of its tree:

    PYTHONPATH=src python <path to this file> parent

The file imports only the package it finds, so the same file times a
tree that does not have it. It runs on the card only.
"""
from __future__ import annotations

import json
import sys

import torch

# (B, S, H, KV, hd, causal): kimi-k2's hd 112, whisper's encoder,
# command-r's and yi-9b's long prefill, yi-9b's short prefill, gemma3-12b's
# global layers at hd 256, qwen2-vl's 1024 patches + 256 tokens
SHAPES = ((1, 4096, 64, 8, 112, True), (4, 1500, 16, 16, 64, False),
          (1, 4096, 64, 8, 128, True), (1, 4096, 32, 4, 128, True),
          (4, 256, 32, 4, 128, True), (1, 2048, 16, 8, 256, True),
          (4, 1280, 12, 2, 128, True))
# the backward's (B, S, H, KV, hd), causal: gpt's and yi-9b's training steps
BWD_SHAPES = ((8, 1024, 12, 12, 64), (1, 4096, 32, 4, 128))
CALLS = 30


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


def main(argv=None) -> int:
    from repro_torch.kernels import flash_attention as fa
    label = (argv if argv is not None else sys.argv[1:] or ["k2"])[0]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this times the card's kernels")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for B, S, H, KV, hd, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                   .bfloat16() for n in (H, KV, KV))
        out[f"{B}x{S} {H}/{KV} hd{hd}"] = time_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal), CALLS, flush)
    bwd = {}
    for B, S, H, KV, hd in BWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dy = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                       .bfloat16() for n in (H, KV, KV, H))
        lse = fa.new_lse(q)
        o = fa.flash_attention(q, k, v, causal=True, lse=lse)
        bwd[f"{B}x{S} {H}/{KV} hd{hd}"] = time_ms(
            lambda: fa.flash_attention_bwd_bf16(q, k, v, o, lse, dy,
                                                causal=True), CALLS, flush)
    print(json.dumps({"label": label, "ms": out, "backward_ms": bwd,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

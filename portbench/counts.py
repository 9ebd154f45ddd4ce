"""The benchmark's yardstick: data-sheet peaks, and the operations and bytes
that each kernel call and each model step need, worked out from shapes.

Every count here is what the inputs need, whatever implements it: each
input byte read once, each output byte written once, and the (query, key)
pairs that the mask lets through. Nothing is read from the program.
"""
from __future__ import annotations

# Data-sheet peaks (dense): bytes/s of device memory, bf16 tensor-core and
# fp32 (outside the tensor cores) operations/s; matched by substring of
# ``torch.cuda.get_device_name``, the first match wins.
PEAKS = (
    ("H100 PCIe", dict(bytes=2.0e12, bf16=756e12, fp32=51e12)),
    ("H100 NVL", dict(bytes=3.9e12, bf16=835e12, fp32=60e12)),
    ("H200", dict(bytes=4.8e12, bf16=989e12, fp32=67e12)),
    ("H100", dict(bytes=3.35e12, bf16=989e12, fp32=67e12)),  # SXM5 80GB HBM3
)

BF16_BYTES = 2
F32_BYTES = 4


def peaks_for(device_name: str) -> dict:
    for key, val in PEAKS:
        if key in device_name:
            return val
    raise KeyError(f"no data-sheet peaks for {device_name!r}")


def attention_pairs(S: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs a (batch, head) needs: S*Sk; S(S+1)/2 when causal;
    with a causal window w < S, w(w+1)/2 + (S - w) w."""
    if not causal:
        return S * Sk
    if window and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


def bound_s(nbytes: float, nops: float, peaks: dict) -> float:
    """The least time the card could take: the larger of bytes at the
    memory peak and operations at the bf16 tensor-core peak."""
    return max(nbytes / peaks["bytes"], nops / peaks["bf16"])


# ---------------------------------------------------------------------------
# K1 RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + scale), rows of D
# ---------------------------------------------------------------------------

def k1_forward_bytes(rows: int, D: int, es: int = BF16_BYTES) -> int:
    """x read, y written, the scale read."""
    return (2 * rows * D + D) * es


def k1_backward_bytes(rows: int, D: int, es: int = BF16_BYTES) -> int:
    """x and dy read, dx written; the scale read, its gradient written."""
    return (3 * rows * D + 2 * D) * es


# ---------------------------------------------------------------------------
# K2 flash attention: q (B, S, H, hd), k and v (B, S, KV, hd)
# ---------------------------------------------------------------------------

def k2_forward_ops(B, S, H, hd, causal=True, window=0) -> int:
    """Two products (QK^T, PV) of 2 operations a multiply-add."""
    return 4 * B * H * hd * attention_pairs(S, S, causal, window)


def k2_backward_ops(B, S, H, hd, causal=True, window=0) -> int:
    """Five products (S recomputed, dP, dV, dK, dQ): 2.5x the forward's."""
    return 10 * B * H * hd * attention_pairs(S, S, causal, window)


def k2_forward_bytes(B, S, H, KV, hd, lse: bool, es: int = BF16_BYTES) -> int:
    """q, k, v read, the output written; the fp32 log-sum-exp written where
    the backward will read it."""
    return (2 * B * S * H * hd + 2 * B * S * KV * hd) * es \
        + (B * H * S * F32_BYTES if lse else 0)


def k2_backward_bytes(B, S, H, KV, hd, es: int = BF16_BYTES) -> int:
    """q, o, dy and k, v read, dq and dk, dv written; the LSE read."""
    return (4 * B * S * H * hd + 4 * B * S * KV * hd) * es \
        + B * H * S * F32_BYTES


# ---------------------------------------------------------------------------
# Model FLOPs of a step
# ---------------------------------------------------------------------------

def product_params(c: dict) -> int:
    """Parameters a token multiplies through (the products' weights), from
    a configuration file's sizes: every layer's projections, the dense MLP
    or the router and the experts a token is routed to, and the
    unembedding. The input embedding is a gather and the norms are no
    products, so neither counts."""
    d, H, KV = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // H
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d
    if c.get("num_local_experts"):
        per_layer += d * c["num_local_experts"] \
            + c["num_experts_per_tok"] * 3 * d * c["intermediate_size"]
    else:
        per_layer += 3 * d * c["intermediate_size"]
    return c["num_hidden_layers"] * per_layer + d * c["vocab_size"]


def forward_flops(c: dict, seq_lens, window: int = 0) -> int:
    """Model FLOPs of one forward over sequences of ``seq_lens``: 2 a
    product weight a token, and each layer's causal attention pairs at 4 hd
    a pair a head."""
    H = c["num_attention_heads"]
    hd = c.get("head_dim") or c["hidden_size"] // H
    flops = 0
    for S in seq_lens:
        flops += 2 * product_params(c) * S
        flops += c["num_hidden_layers"] * 4 * H * hd \
            * attention_pairs(S, S, True, window)
    return flops


def step_flops(c: dict, seq_lens, train: bool, window: int = 0) -> int:
    """A step's model FLOPs: the forward's, x3 for a training step (the
    backward's two products a forward product); no recomputation."""
    return (3 if train else 1) * forward_flops(c, seq_lens, window)

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
# K2 flash attention: q (B, S, H, d_qk), k (B, S, KV, d_qk), v (B, S, KV, d_v)
# ---------------------------------------------------------------------------

def attention_dims(c: dict):
    """``(H, KV, d_qk, d_v)`` of a configuration's attention core, read
    under the published config's names. Latent attention (MLA, wherever
    ``kv_lora_rank`` is present) in its prefill form: every head its own
    k and v, ``d_qk = qk_nope_head_dim + qk_rope_head_dim``, ``d_v =
    v_head_dim``. GQA: ``head_dim`` (or hidden / heads) for both."""
    H = c["num_attention_heads"]
    if c.get("kv_lora_rank"):
        return H, H, c["qk_nope_head_dim"] + c["qk_rope_head_dim"], \
            c["v_head_dim"]
    hd = c.get("head_dim") or c["hidden_size"] // H
    return H, c["num_key_value_heads"], hd, hd


def k2_forward_ops(B, S, H, hd, causal=True, window=0, d_v=None) -> int:
    """Two products, QK^T at ``hd`` (d_qk) and PV at ``d_v`` (``hd`` where
    not given), of 2 operations a multiply-add."""
    d_v = hd if d_v is None else d_v
    return 2 * B * H * (hd + d_v) * attention_pairs(S, S, causal, window)


def k2_backward_ops(B, S, H, hd, causal=True, window=0, d_v=None) -> int:
    """Five products: S recomputed, dK and dQ at d_qk, dP and dV at
    ``d_v``; 2.5x the forward's where the two are equal."""
    d_v = hd if d_v is None else d_v
    return 2 * B * H * (3 * hd + 2 * d_v) \
        * attention_pairs(S, S, causal, window)


def k2_forward_bytes(B, S, H, KV, hd, lse: bool, es: int = BF16_BYTES,
                     d_v=None) -> int:
    """q and k read at ``hd`` (d_qk), v read and the output written at
    ``d_v``; the fp32 log-sum-exp written where the backward will read
    it."""
    d_v = hd if d_v is None else d_v
    return (B * S * H * (hd + d_v) + B * S * KV * (hd + d_v)) * es \
        + (B * H * S * F32_BYTES if lse else 0)


def k2_backward_bytes(B, S, H, KV, hd, es: int = BF16_BYTES, d_v=None) -> int:
    """q, o, dy and k, v read, dq and dk, dv written (q, k and their
    gradients at ``hd``, the rest at ``d_v``); the LSE read."""
    d_v = hd if d_v is None else d_v
    return (2 * B * S * H * (hd + d_v) + 2 * B * S * KV * (hd + d_v)) * es \
        + B * H * S * F32_BYTES


# ---------------------------------------------------------------------------
# Model FLOPs of a step
# ---------------------------------------------------------------------------

EXPERT_KEYS = ("n_routed_experts", "num_local_experts")


def attention_params(c: dict) -> int:
    """One layer's attention projections. GQA: q, k, v and o. MLA: q
    (through ``q_lora_rank`` where it is set), the joint kv down-projection
    with the rope key, the kv up-projection to every head's nope key and
    value, and o."""
    d = c["hidden_size"]
    H, KV, d_qk, d_v = attention_dims(c)
    if not c.get("kv_lora_rank"):
        return d * H * d_qk + 2 * d * KV * d_qk + H * d_qk * d
    r_kv, rope = c["kv_lora_rank"], c["qk_rope_head_dim"]
    r_q = c.get("q_lora_rank")
    q = d * r_q + r_q * H * d_qk if r_q else d * H * d_qk
    kv_a = d * (r_kv + rope)
    kv_b = r_kv * H * (c["qk_nope_head_dim"] + d_v)
    return q + kv_a + kv_b + H * d_v * d


def expert_counts(c: dict):
    """``(held, router)``: the experts a layer holds here (the key that
    counts them, ``n_routed_experts`` or ``num_local_experts``) and the
    router's width: the published count where that key is ``reduced``
    (the chip's share of an expert-parallel layer), else the same.
    ``(0, 0)`` for a dense model."""
    key = next((k for k in EXPERT_KEYS if c.get(k)), None)
    if key is None:
        return 0, 0
    held = c[key]
    if key in c.get("reduced", ()):
        return held, c["published"][key]
    return held, held


def mlp_params(c: dict) -> int:
    """Every layer's MLP products a token passes: the
    ``first_k_dense_replace`` leading layers (all, in a dense model) dense
    at ``intermediate_size``; each MoE layer its router over the published
    experts, ``n_shared_experts`` shared experts, and the routed experts'
    products at ``moe_intermediate_size`` (``intermediate_size`` under
    Mixtral's keys). The routed term is a balanced router's expected rows:
    of a token's ``num_experts_per_tok`` experts, the share ``held /
    router`` lies here (rounded down where that is not whole)."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    held, router = expert_counts(c)
    dense = 3 * d * c["intermediate_size"]
    if not held:
        return L * dense
    k_dense = min(c.get("first_k_dense_replace", 0), L)
    f = c.get("moe_intermediate_size") or c["intermediate_size"]
    moe = d * router + c.get("n_shared_experts", 0) * 3 * d * f \
        + c["num_experts_per_tok"] * held * 3 * d * f // router
    return k_dense * dense + (L - k_dense) * moe


def product_params(c: dict) -> int:
    """Parameters a token multiplies through (the products' weights), from
    a configuration file's sizes: every layer's attention projections
    (``attention_params``), its MLP (``mlp_params``), and the unembedding.
    The input embedding is a gather and the norms are no products, so
    neither counts."""
    return c["num_hidden_layers"] * attention_params(c) + mlp_params(c) \
        + c["hidden_size"] * c["vocab_size"]


def forward_flops(c: dict, seq_lens, window: int = 0) -> int:
    """Model FLOPs of one forward over sequences of ``seq_lens``: 2 a
    product weight a token, and each layer's causal attention pairs at
    ``2 H (d_qk + d_v)`` a pair."""
    H, _, d_qk, d_v = attention_dims(c)
    flops = 0
    for S in seq_lens:
        flops += 2 * product_params(c) * S
        flops += c["num_hidden_layers"] * 2 * H * (d_qk + d_v) \
            * attention_pairs(S, S, True, window)
    return flops


def step_flops(c: dict, seq_lens, train: bool, window: int = 0) -> int:
    """A step's model FLOPs: the forward's, x3 for a training step (the
    backward's two products a forward product); no recomputation."""
    return (3 if train else 1) * forward_flops(c, seq_lens, window)


def k1_norms(c: dict):
    """``[(launches, width)]``: K1's launches in one forward: two a layer
    and the last at ``hidden_size``; a layer's at ``q_lora_rank`` where it
    is set, and at ``kv_lora_rank`` under MLA."""
    L = c["num_hidden_layers"]
    out = [(2 * L + 1, c["hidden_size"])]
    if c.get("kv_lora_rank"):
        if c.get("q_lora_rank"):
            out.append((L, c["q_lora_rank"]))
        out.append((L, c["kv_lora_rank"]))
    return out

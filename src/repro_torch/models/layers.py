"""Shared model building blocks (PyTorch, config-driven).

Parameters are built from *leaf specs* — one source of truth giving shape,
logical sharding axes and init scale — so random init, the JAX-weight
converter, the parameter count and the logical-axes tree all derive from
the same structure. Weights keep the JAX package's ``(d_in, d_out)`` layout
and are applied as ``x @ W``.

RMSNorm always goes through the RMSNorm kernel's dispatch
(``kernels.ops.rmsnorm``); attention goes through the flash-attention
kernel's dispatch where the kernel's semantics hold (see ``attention``).
On a CPU tensor both dispatch to the plain version.

``constrain`` marks the JAX package's sharding constraints, with the same
logical axes at the same places: under an active mesh
(``sharding.specs.use_sharding``) with DTensor parameters each is a
redistribute, and otherwise the identity. ``remat_call`` is the JAX
package's per-block ``jax.checkpoint`` when ``cfg.remat`` is set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..sharding.specs import (active_mesh, active_rules, constrain,
                              heads_local, is_dtensor, use_sharding)
from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Leaf specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Leaf:
    shape: tuple
    logical: tuple
    scale: float = 1.0          # stddev multiplier (fan-in scaling applied)
    dtype: Optional[str] = None


class Params(nn.Module):
    """A module whose parameters follow a spec: a ``Leaf`` becomes a
    parameter, a dict a child ``Params``, a list a ``ModuleList`` of them.
    Parameters are allocated uninitialised; see ``init_tree``."""

    def __init__(self, spec: dict, dtype: torch.dtype, device):
        super().__init__()
        self.leaves = {}
        for name, item in spec.items():
            if isinstance(item, Leaf):
                self.leaves[name] = item
                dt = getattr(torch, item.dtype) if item.dtype else dtype
                self.register_parameter(name, nn.Parameter(
                    torch.empty(item.shape, dtype=dt, device=device),
                    requires_grad=False))
            elif isinstance(item, dict):
                self.add_module(name, Params(item, dtype, device))
            else:
                self.add_module(name, nn.ModuleList(
                    Params(s, dtype, device) for s in item))


class Model(Params):
    """A family's model: the parameters of ``spec`` and the config. Weights
    are allocated uninitialised; build it through ``registry.init_params``
    or ``convert.from_jax``."""

    def __init__(self, spec: dict, cfg: ModelConfig, device):
        super().__init__(spec, cfg.torch_dtype, device)
        self.cfg = cfg


# A leaf of more elements than this is drawn in slices along its leading
# axis, so that its float32 draw never takes more than 512 MiB beside it
# (one kimi-k2 expert leaf is 5.6e9 elements: 22.5 GB in float32).
DRAW_ELEMENTS = 2**27


def init_leaf_(t: torch.Tensor, lf: Leaf, generator: torch.Generator):
    """Zeros for scale 0, ones for scale -1 (norm-like leaves), else a
    normal draw with std = scale / sqrt(fan_in), as the JAX package's
    ``init_tree``; the bits come from ``generator``, not ``jax.random``."""
    if lf.scale == 0.0:
        t.zero_()
        return
    if lf.scale == -1.0:
        t.fill_(1.0)
        return
    fan_in = lf.shape[-2] if len(lf.shape) >= 2 else lf.shape[-1]
    std = lf.scale / math.sqrt(max(fan_in, 1))
    row = math.prod(lf.shape[1:])
    step = max(1, DRAW_ELEMENTS // max(row, 1)) if t.numel() > DRAW_ELEMENTS \
        else lf.shape[0]
    for i in range(0, lf.shape[0], step):
        part = t[i:i + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=t.device, dtype=torch.float32) * std)


@torch.no_grad()
def init_tree(module: nn.Module, generator: torch.Generator):
    """Fill every spec'd parameter, in module order, from ``generator``."""
    for mod in module.modules():
        if isinstance(mod, Params):
            for name, lf in mod.leaves.items():
                init_leaf_(getattr(mod, name), lf, generator)


def spec_leaves(spec):
    """All Leafs of a spec, depth first."""
    items = spec.values() if isinstance(spec, dict) else spec
    for item in items:
        if isinstance(item, Leaf):
            yield item
        else:
            yield from spec_leaves(item)


def logical_tree(spec, stacked: bool = False):
    """The spec's logical axes as a nested dict (``stacked``: each behind a
    ``"layers"`` axis, as the JAX package stacks a layer group's leaves)."""
    return {k: ((("layers",) if stacked else ()) + v.logical
                if isinstance(v, Leaf) else logical_tree(v, stacked))
            for k, v in spec.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    # float32 activations over bf16 weights (mamba2's out_norm in prefill):
    # the scale is widened, exactly, as the JAX package's astype(f32) does
    if scale.dtype != x.dtype:
        scale = scale.to(x.dtype)
    return ops.rmsnorm(x, scale, eps)


def causal_conv(x, w, b):
    """Depthwise causal conv of width K as K shifted adds: x (B, S, C),
    w (K, C), b (C,)."""
    K = w.shape[0]
    acc = x * w[K - 1]
    for k in range(1, K):
        acc = acc + F.pad(x, (0, 0, k, 0))[:, :-k] * w[K - 1 - k]
    return acc + b


def norm_spec(d: int) -> Leaf:
    return Leaf((d,), ("embed",), scale=0.0)


# ---------------------------------------------------------------------------
# RoPE (incl. M-RoPE for the VLM backbone)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd // 2, dtype=torch.float32,
                                         device=device) / (hd // 2)))


def rope_angles(positions, hd: int, theta: float, mrope_sections=None):
    """positions: (..., S) int or (..., S, 3) for M-RoPE -> (..., S, hd//2).

    M-RoPE (Qwen2-VL): the frequency bands are cut into (t, h, w) sections,
    each rotated by its own position stream."""
    freqs = rope_freqs(hd, theta, positions.device)
    if mrope_sections is None:
        return positions[..., None].float() * freqs
    if sum(mrope_sections) != hd // 2:
        raise ValueError(f"mrope sections {mrope_sections} do not sum to "
                         f"{hd // 2}")
    parts = []
    off = 0
    for i, s in enumerate(mrope_sections):
        parts.append(positions[..., i].float()[..., None]
                     * freqs[off:off + s])
        off += s
    return torch.cat(parts, dim=-1)


def apply_rope(x, angles):
    """x: (B, S, H, hd); angles: (B, S, hd//2)."""
    dt = x.dtype
    x = x.float()
    c = torch.cos(angles)[:, :, None, :]
    s = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / bidirectional / softcap)
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    spec = {
        "wq": Leaf((d, h * hd), ("embed_fsdp", "heads")),
        "wk": Leaf((d, kv * hd), ("embed_fsdp", "kv_heads")),
        "wv": Leaf((d, kv * hd), ("embed_fsdp", "kv_heads")),
        "wo": Leaf((h * hd, d), ("heads", "embed_fsdp")),
    }
    if cfg.use_bias:
        spec["bq"] = Leaf((h * hd,), ("heads",), scale=0.0)
        spec["bv"] = Leaf((kv * hd,), ("kv_heads",), scale=0.0)
        spec["bo"] = Leaf((d,), ("embed",), scale=0.0)
    return spec


def _mask(q_pos, k_pos, causal: bool, window: int):
    """q_pos: (Sq,), k_pos: (Sk,) -> (Sq, Sk) bool."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def gqa_attend(q, k, v, mask, softcap: float = 0.0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), mask broadcastable (B,1,Sq,Sk).

    Scores in the input dtype, softmax in fp32, weights cast back to v's
    dtype before the value product, as the JAX package does. On a mesh,
    on local shards: each rank's q heads against the KV heads they read
    (``sharding.specs.heads_local``)."""
    if is_dtensor(q):
        return heads_local(lambda ql, kl, vl, m: _gqa_attend(
            ql, kl, vl, m, softcap), q, k, v, mask)
    return _gqa_attend(q, k, v, mask, softcap)


def _gqa_attend(q, k, v, mask, softcap: float = 0.0):
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, NEG_INF)
    scores = constrain(scores, ("batch", "act_heads", None, None))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


ATTN_CHUNK = 1024       # q-block size for chunked attention
CHUNK_THRESHOLD = 2048  # use chunked path above this sequence length


def gqa_attend_chunked(q, k, v, q_pos, k_pos, *, causal, window,
                       softcap: float = 0.0):
    """Blockwise attention over q chunks with per-chunk K/V slices, so local
    (sliding-window) layers only touch K/V inside the window of each block."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    c = min(ATTN_CHUNK, Sq)
    outs = []
    for s0 in range(0, Sq, c):
        s1 = min(s0 + c, Sq)
        lo = 0
        hi = Sk
        if window:
            lo = max(0, s0 - window + 1)
        if causal and Sk == Sq:
            hi = s1
        m = _mask(q_pos[s0:s1], k_pos[lo:hi], causal, window)[None, None]
        outs.append(gqa_attend(q[:, s0:s1], k[:, lo:hi], v[:, lo:hi], m,
                               softcap))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def plain_attention(q, k, v, q_pos, k_pos, *, causal, window, softcap):
    """The JAX package's XLA attention: one masked pass up to
    ``CHUNK_THRESHOLD`` query rows, q blocks above it."""
    if q.shape[1] > CHUNK_THRESHOLD:
        return gqa_attend_chunked(q, k, v, q_pos, k_pos, causal=causal,
                                  window=window, softcap=softcap)
    m = _mask(q_pos, k_pos, causal, window)[None, None]
    return gqa_attend(q, k, v, m, softcap)


def seq_gathered(x):
    """The sequence-parallel all-gather at a block's entry, on a mesh whose
    rules shard the residual's seq (``REPRO_SP_RESIDUAL``): DTensor's
    product rule takes a batch-sharded input, not one sharded on seq as
    well. The identity without a mesh."""
    return constrain(x, ("batch", None, "embed"))


def heads_proj(x, w, heads: str):
    """``x @ w`` of a (.., heads * hd) projection, on a mesh placed by the
    ``heads`` rule (whole heads or none on a rank): DTensor's product rule
    may otherwise cut the fused dim where its split into heads cannot
    follow. The product itself without a mesh."""
    return constrain(x @ w, ("batch", None, heads))


def attention(p, cfg: ModelConfig, x, positions=None, *, causal=True,
              window=0, kv_override=None, angles=None):
    """Full-sequence attention (prefill). ``positions`` None means
    0..S-1. Returns (y, (k, v)).

    Routing: the flash-attention kernel computes exactly softmax(q k^T
    hd^-0.5) v over keys 0..S-1 of the same sequence, causal or not, and
    under the causal mask with a sliding window (``_mask``'s). So a layer
    goes to it when it has no softcap, no ``kv_override`` (cross-attention:
    other keys, Sk != S) and default positions, whatever its window (a
    window without the causal mask, which no config makes, excepted);
    every other layer keeps the plain path, as the JAX package keeps
    XLA."""
    B, S, D = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = seq_gathered(x)
    q = heads_proj(x, p.wq, "act_heads").reshape(B, S, h, hd)
    if cfg.use_bias:
        q = q + p.bq.reshape(1, 1, h, hd)
    ksrc = x if kv_override is None else seq_gathered(kv_override)
    Sk = ksrc.shape[1]
    k = heads_proj(ksrc, p.wk, "kv_heads").reshape(B, Sk, kv, hd)
    v = heads_proj(ksrc, p.wv, "kv_heads").reshape(B, Sk, kv, hd)
    if cfg.use_bias:
        v = v + p.bv.reshape(1, 1, kv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        if kv_override is None:
            k = apply_rope(k, angles)
    # inside the block, seq is gathered (SP boundary is the residual)
    q = constrain(q, ("batch", None, "act_heads", None))
    k = constrain(k, ("batch", None, None, None))
    if not cfg.logit_softcap and kv_override is None and positions is None \
            and (causal or not window):
        y = ops.flash_attention(q, k, v, causal=causal,
                                window=window).reshape(B, S, h * hd)
    else:
        q_pos = torch.arange(S, device=x.device) if positions is None \
            else positions
        k_pos = q_pos if kv_override is None \
            else torch.arange(Sk, device=x.device)
        y = plain_attention(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, softcap=cfg.logit_softcap)
    y = y @ p.wo
    if cfg.use_bias:
        y = y + p.bo
    return constrain(y, ("batch", "seq", "embed")), (k, v)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                     window=0, rope=True):
    """Single-token decode. cache_{k,v}: (B, C, KV, hd). ``window`` selects
    ring-buffer semantics (C == window) vs linear cache (C == max seq).
    ``rope=False`` for families whose prefill attention runs unrotated
    (whisper's decoder self-attention).

    Unlike the JAX package, the new K/V row is written into the caches in
    place (the returned caches are the same tensors), which saves a copy of
    every cache at every step."""
    B, S1, D = x.shape
    assert S1 == 1
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    C = cache_k.shape[1]
    q = heads_proj(x, p.wq, "act_heads").reshape(B, 1, h, hd)
    if cfg.use_bias:
        q = q + p.bq.reshape(1, 1, h, hd)
    k_new = heads_proj(x, p.wk, "kv_heads").reshape(B, 1, kv, hd)
    v_new = heads_proj(x, p.wv, "kv_heads").reshape(B, 1, kv, hd)
    if cfg.use_bias:
        v_new = v_new + p.bv.reshape(1, 1, kv, hd)
    if rope:
        ang = rope_angles(torch.full((B, 1), pos, device=x.device), hd,
                          cfg.rope_theta)
        q = apply_rope(q, ang)
        k_new = apply_rope(k_new, ang)
    slot = pos % C if window > 0 else pos  # ring buffer vs linear cache
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    idx = torch.arange(C, device=x.device)
    if window > 0:
        valid = idx < min(pos + 1, C)
    else:
        valid = idx <= pos
    m = valid[None, None, None, :]
    y = gqa_attend(q, cache_k, cache_v, m, cfg.logit_softcap)
    y = y @ p.wo
    if cfg.use_bias:
        y = y + p.bo
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (geglu / gelu)
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, geglu: bool = True) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if geglu:
        return {
            "wg": Leaf((d, f), ("embed_fsdp", "ff")),
            "wu": Leaf((d, f), ("embed_fsdp", "ff")),
            "wd": Leaf((f, d), ("ff", "embed_fsdp")),
        }
    spec = {
        "w1": Leaf((d, f), ("embed_fsdp", "ff")),
        "w2": Leaf((f, d), ("ff", "embed_fsdp")),
    }
    if cfg.use_bias:
        spec["b1"] = Leaf((f,), ("ff",), scale=0.0)
        spec["b2"] = Leaf((d,), ("embed",), scale=0.0)
    return spec


def residual_branch(y):
    """A block branch's output placed as the residual it joins: a mesh's
    row-parallel product leaves a partial sum, reduced here rather than
    inside the residual add, whose gradient would otherwise come back
    sharded as the residual is. The identity without a mesh."""
    return constrain(y, ("batch", "seq", "embed"))


def mlp(p, x):
    x = seq_gathered(x)
    if hasattr(p, "wg"):
        h = F.silu(x @ p.wg) * (x @ p.wu)
        return residual_branch(constrain(h, ("batch", None, "act_ff"))
                               @ p.wd)
    h = x @ p.w1
    if hasattr(p, "b1"):
        h = h + p.b1
    h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    h = constrain(h, ("batch", None, "act_ff"))
    y = h @ p.w2
    if hasattr(p, "b2"):
        y = y + p.b2
    return residual_branch(y)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(cfg: ModelConfig) -> dict:
    spec = {"embed": Leaf((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"))}
    if not cfg.tie_embeddings:
        spec["unembed"] = Leaf((cfg.d_model, cfg.vocab),
                               ("embed_fsdp", "vocab"))
    return spec


def take_rows(table, tokens):
    """``table[tokens]``; on a mesh ``F.embedding``, whose DTensor rule
    gathers from a vocab-sharded table without gathering the table."""
    if active_mesh() is not None:
        return F.embedding(tokens, table)
    return table[tokens]


def embed(p, cfg: ModelConfig, tokens):
    x = take_rows(p.embed, tokens).to(cfg.torch_dtype)
    if cfg.family in ("dense", "moe", "vlm"):
        x = x * math.sqrt(cfg.d_model)  # gemma-style scaling
    return constrain(x, ("batch", "seq", "embed"))


def unembed(p, cfg: ModelConfig, x):
    w = p.embed.T if cfg.tie_embeddings else p.unembed
    # vocab-parallel logits; seq explicitly gathered
    return constrain(x @ w.to(cfg.torch_dtype), ("batch", None, "vocab"))


def remat_call(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``:
    the block's activations are recomputed in the backward instead of
    kept (the JAX package's per-block ``jax.checkpoint``)."""
    if not cfg.remat:
        return fn(*args)
    mesh, rules = active_mesh(), active_rules()
    if mesh is None:
        return checkpoint(fn, *args, use_reentrant=False)

    def block(*a):
        # the recompute runs in the backward, on autograd's device thread
        # for CUDA tensors, where this thread's sharding context is unset
        with use_sharding(mesh, rules):
            return fn(*a)

    return checkpoint(block, *args, use_reentrant=False)

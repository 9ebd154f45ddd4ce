"""Block program library: per-block (G_s, G_d) pairs for whole-model checks.

Each builder returns an :class:`Obligation` pairing a sequential block
fragment with its per-rank SPMD implementation, written against
``repro_torch.core.spmd``, under a
:class:`repro_torch.sharding.specs.MeshPlan`:

  * ``embed``      feature-sharded embedding gather + tp all_gather
  * ``layer``      pre-norm transformer block: RMSNorm -> multi-head
                   (masked, linear) attention with Megatron col/row-sharded
                   projections + tp psum -> residual -> RMSNorm -> GeGLU
                   MLP (col/row + psum) -> residual
  * ``moe_layer``  same attention sublayer; the MLP is an expert-parallel
                   soft-routed expert sum (experts sharded over tp)
  * ``head``       final RMSNorm + vocab-parallel logits (+ softcap)

Dimensions come from ``ModelConfig.reduced()`` — the engine is symbolic,
so verification cost is driven by operator count and mesh size, not tensor
extents; reduced extents keep tracing fast while every structural fact
(heads, pattern role, windowing, softcap, expert count) survives and is
part of the obligation's dedup fingerprint.

Attention is *linear* attention (scores are mask-weighted q.k^T without a
softmax): data-dependent renormalization is outside any symbolic engine's
fragment, while the sharded computation structure — head-split score/value
bmms, the causal/sliding-window mask, col/row projections and the
cross-rank psum — is exactly the part distribution strategies get wrong.

The programs keep the JAX package's operator order, since lemma fire
counts follow the captured op structure: SiLU is ``h * sigmoid(h)`` (the
JAX capture sees ``logistic`` and ``mul``), the gather is
``F.embedding`` (the JAX ``take``), and the score and value products are
written as the ``dot_general`` the JAX capture canonicalizes ``einsum``
to (transpose the operands to batch-major, one batched product).  A
layer's mask is a constant made on the capture device, so
``layer_obligation`` takes ``device`` (``cuda`` unless ``"cpu"`` is asked
for).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api.spec import TensorSpec
from ..core import spmd
from ..core.spmd import PartitionSpec
from ..models.config import ModelConfig
from ..models.registry import resolve_device
from ..sharding.specs import MeshPlan
from .obligations import Obligation

# default activation extents per block check: dp shards the batch dim
# (attention mixes across seq, so seq stays whole per rank)
BATCH = 4
SEQ = 4


class BlockBuildError(ValueError):
    pass


def _aval(shape, dtype=torch.float32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def _check_div(what: str, n: int, axis: str, deg: int):
    if n % deg:
        raise BlockBuildError(
            f"{what} ({n}) not divisible by {axis} degree {deg}")


def reduced_dims(cfg: ModelConfig, plan: MeshPlan) -> dict:
    """Engine-sized dims for the block programs, divisibility-checked
    against the plan."""
    r = cfg.reduced(n_layers=cfg.n_layers)
    d = {
        "d_model": r.d_model, "n_heads": r.n_heads, "head_dim": r.hd,
        "d_ff": r.d_ff or 4 * r.d_model, "vocab": r.vocab,
        "n_experts": r.n_experts, "moe_d_ff": r.moe_d_ff or r.d_model,
        "window": max(r.window, 2) if cfg.window else 0,
        "eps": cfg.norm_eps, "softcap": bool(cfg.logit_softcap),
        "batch": BATCH, "seq": SEQ,
    }
    dp, tp = plan.axis("dp"), plan.axis("tp")
    _check_div("batch", d["batch"], "dp", dp)
    for k in ("d_model", "d_ff", "vocab"):
        _check_div(k, d[k], "tp", tp)
    _check_div("n_heads", d["n_heads"], "tp", tp)
    if d["n_experts"]:
        _check_div("n_experts", d["n_experts"], "tp", tp)
    return d


def _mask(role: str, S: int, window: int) -> np.ndarray:
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    m = (k <= q)
    if role == "local" and window:
        m &= (q - k) < window
    return m.astype(np.float32)


def _rms(x, g, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    # ``1.0 + g`` with the literal first, as jnp records it
    one = torch.scalar_tensor(1.0, dtype=g.dtype, device=g.device)
    return x * torch.rsqrt(var + eps) * (one + g)


def _attn(x, wq, wk, wv, wo, mask4, hd):
    """Linear attention; ``mask4`` is the (1, 1, S, S) mask constant."""
    B, S, _ = x.shape
    q = (x @ wq).reshape(B, S, -1, hd)
    k = (x @ wk).reshape(B, S, -1, hd)
    v = (x @ wv).reshape(B, S, -1, hd)
    # einsum("bqhd,bkhd->bhqk"): batch (b, h) first, contract d
    s = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * mask4
    # einsum("bhqk,bkhd->bqhd"), as jnp contracts it: (v^T s^T) over
    # batch (b, h), then to the output order
    y = torch.matmul(v.permute(0, 2, 3, 1), s.permute(0, 1, 3, 2)) \
        .permute(0, 3, 1, 2)
    return y.reshape(B, S, -1) @ wo


def replay_inputs(ob: Obligation, seed: int = 0, device=None) -> dict:
    """Global inputs for the numeric replay of ``ob``'s certificate
    (``repro_torch.api.replay``), at the scale a model holds them: token
    ids uniform over the table's rows, matrices N(0, 1/fan_in) with dim
    -2 as the fan-in, every other float input N(0, 1); drawn in input
    order from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``cuda`` unless ``"cpu"`` is asked for).  The replay's own draw,
    N(0, 0.3^2) for every input, grows a block's unnormalized linear
    attention to ~10^3, where float32 rounding alone puts cancelling
    elements beyond its rtol = atol = 2e-4."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = dict(zip(ob.input_names, (shape for shape, _ in ob.avals)))
    out = {}
    for name, (shape, dtype) in zip(ob.input_names, ob.avals):
        if not dtype.is_floating_point:
            out[name] = torch.randint(0, shapes["table"][0], shape,
                                      generator=g, device=dev, dtype=dtype)
            continue
        x = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        out[name] = x / shape[-2] ** 0.5 if len(shape) >= 2 \
            and name not in ("x", "table") else x
    return out


# ---------------------------------------------------------------------------
# embed
# ---------------------------------------------------------------------------

def embed_obligation(cfg: ModelConfig, plan: MeshPlan) -> Obligation:
    d = reduced_dims(cfg, plan)
    B, S, V, D = d["batch"], d["seq"], d["vocab"], d["d_model"]
    tp = "tp" if plan.axis("tp") > 1 else None

    def take(tokens, table):
        # jnp.take's gather: negative ids wrap around the vocabulary
        idx = torch.where(tokens < 0, tokens + table.shape[0], tokens)
        return torch.nn.functional.embedding(idx, table)

    def seq_fn(tokens, table):
        return take(tokens, table)

    def dist_fn(tokens, table):
        x = take(tokens, table)
        if tp:
            x = spmd.all_gather(x, tp, axis=2, tiled=True)
        return x

    return Obligation(
        kind="embed", seq_fn=seq_fn, dist_fn=dist_fn,
        mesh_axes=plan.axes,
        in_specs=(plan.spec_for(("batch", "seq")),
                  plan.spec_for(("vocab_rows", "embed_tp"))),
        out_specs=(plan.spec_for(("batch", "seq", "embed")),),
        avals=(_aval((B, S), torch.int32), _aval((V, D))),
        input_names=("tokens", "table"),
        structure=(("B", B), ("S", S), ("V", V), ("D", D)),
        description="feature-sharded embedding gather (+ tp all_gather)")


# ---------------------------------------------------------------------------
# transformer / MoE layer
# ---------------------------------------------------------------------------

def layer_obligation(cfg: ModelConfig, plan: MeshPlan, role: str = "global",
                     moe: bool = False, bug: Optional[str] = None,
                     device=None) -> Obligation:
    d = reduced_dims(cfg, plan)
    B, S = d["batch"], d["seq"]
    D, H, hd = d["d_model"], d["n_heads"], d["head_dim"]
    F, eps, window = d["d_ff"], d["eps"], d["window"]
    E, FE = d["n_experts"], d["moe_d_ff"]
    tp_deg = plan.axis("tp")
    tp = "tp" if tp_deg > 1 else None
    mask4 = torch.from_numpy(_mask(role, S, window)[None, None]).to(
        resolve_device(device))
    if moe and not E:
        raise BlockBuildError(f"{cfg.name}: moe block without experts")

    def attn_sub(x, g1, wq, wk, wv, wo, *, dist):
        a = _attn(_rms(x, g1, eps), wq, wk, wv, wo, mask4, hd)
        if dist and tp:
            a = spmd.psum(a, tp)
        return x + a

    def mlp_sub(x, g2, wg, wu, wd, *, dist):
        h = _rms(x, g2, eps)
        hg = h @ wg
        m = (hg * torch.sigmoid(hg) * (h @ wu)) @ wd
        if dist and tp:
            m = spmd.psum(m, tp)
        return x + m

    def moe_sub(x, g2, w1, w2, *, dist):
        h = _rms(x, g2, eps)
        n_local = w1.shape[0]
        m = None
        for e in range(n_local):
            y = torch.tanh(h @ w1[e]) @ w2[e]
            m = y if m is None else m + y
        if dist and tp:
            m = spmd.psum(m, tp)
        return x + m

    if moe:
        def seq_fn(x, g1, wq, wk, wv, wo, g2, w1, w2):
            x = attn_sub(x, g1, wq, wk, wv, wo, dist=False)
            return moe_sub(x, g2, w1, w2, dist=False)

        def dist_fn(x, g1, wq, wk, wv, wo, g2, w1, w2):
            x = attn_sub(x, g1, wq, wk, wv, wo, dist=True)
            return moe_sub(x, g2, w1, w2, dist=True)

        mlp_names = ("w1", "w2")
        mlp_avals = (_aval((E, D, FE)), _aval((E, FE, D)))
        mlp_logical = [("experts", "embed", "expert_ff"),
                       ("experts", "expert_ff", "embed")]
    else:
        def seq_fn(x, g1, wq, wk, wv, wo, g2, wg, wu, wd):
            x = attn_sub(x, g1, wq, wk, wv, wo, dist=False)
            return mlp_sub(x, g2, wg, wu, wd, dist=False)

        def dist_fn(x, g1, wq, wk, wv, wo, g2, wg, wu, wd):
            x = attn_sub(x, g1, wq, wk, wv, wo, dist=True)
            return mlp_sub(x, g2, wg, wu, wd, dist=True)

        mlp_names = ("wg", "wu", "wd")
        mlp_avals = (_aval((D, F)), _aval((D, F)), _aval((F, D)))
        mlp_logical = [("embed", "ff"), ("embed", "ff"), ("ff", "embed")]

    logical = [("batch", "seq", "embed"),                # x
               ("embed",),                               # g1
               ("embed", "heads"), ("embed", "kv_heads"),
               ("embed", "kv_heads"), ("heads", "embed"),
               ("embed",)] + mlp_logical                 # g2 + mlp weights
    in_specs = [plan.spec_for(ax) for ax in logical]
    if bug == "wrong_spec":
        # the injected whole-model bug: the MLP down-projection's partition
        # spec names the wrong mesh axis — its first (sharded) dim is split
        # over dp instead of tp, so every tp group computes with dp-sliced
        # weight rows while still psum-ing over tp
        if plan.axis("dp") != tp_deg or tp is None:
            raise BlockBuildError(
                "wrong_spec needs a 2D plan with equal dp/tp degrees "
                "(the mis-sharded weight must keep its per-rank shape)")
        in_specs[-1] = PartitionSpec(
            "dp", *([None] * (len(mlp_avals[-1].shape) - 1)))
    avals = (_aval((B, S, D)), _aval((D,)), _aval((D, H * hd)),
             _aval((D, H * hd)), _aval((D, H * hd)), _aval((H * hd, D)),
             _aval((D,))) + mlp_avals
    names = ("x", "g1", "wq", "wk", "wv", "wo", "g2") + mlp_names

    return Obligation(
        kind="moe_block" if moe else "block",
        seq_fn=seq_fn, dist_fn=dist_fn, mesh_axes=plan.axes,
        in_specs=tuple(in_specs),
        out_specs=(plan.spec_for(("batch", "seq", "embed")),),
        avals=avals, input_names=names,
        structure=(("role", role), ("window", window if role == "local"
                                    else 0),
                   ("eps", eps), ("bug", bug or "-")),
        description=("expert-parallel MoE block" if moe else
                     f"transformer block ({role} attention)"))


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

def head_obligation(cfg: ModelConfig, plan: MeshPlan) -> Obligation:
    d = reduced_dims(cfg, plan)
    B, S, D, V = d["batch"], d["seq"], d["d_model"], d["vocab"]
    eps, softcap = d["eps"], d["softcap"]

    def fwd(x, g, wun):
        logits = _rms(x, g, eps) @ wun
        if softcap:
            logits = torch.tanh(logits / 30.0) * 30.0
        return logits

    return Obligation(
        kind="head", seq_fn=fwd, dist_fn=fwd, mesh_axes=plan.axes,
        in_specs=(plan.spec_for(("batch", "seq", "embed")),
                  plan.spec_for(("embed",)),
                  plan.spec_for(("embed", "vocab"))),
        out_specs=(plan.spec_for(("batch", "seq", "vocab")),),
        avals=(_aval((B, S, D)), _aval((D,)), _aval((D, V))),
        input_names=("x", "g", "wun"),
        structure=(("eps", eps), ("softcap", softcap)),
        description="final RMSNorm + vocab-parallel logits"
                    + (" (softcap)" if softcap else ""))

"""Mixture-of-Experts family (mixtral-8x7b, kimi-k2-1t).

Routing is the JAX package's sort-based dispatch with a static per-expert
capacity: tokens are replicated top_k times, sorted by expert id, packed
into an (E, C, D) buffer, run through a batched expert GEMM, then combined
with the router gates. Rows past an expert's capacity C are dropped, and
which rows those are must match the reference exactly, so the port keeps
its orders: the top-k breaks ties toward the lower expert index, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises
no order on ties), and the sort by expert is stable, as ``jnp.argsort``
is. Decode runs the same ``moe_mlp`` with T = B tokens, so a decode step
can drop rows too.

The auxiliary load-balance loss is returned beside the output.

On a mesh (DTensor activations under ``use_sharding``) the block runs on
local shards (``_moe_mlp_mesh``): every rank routes all the tokens, so
capacities and drops are the unsharded model's, and runs the experts its
mesh coordinate holds, on the ``constrain`` placements of the JAX package
(experts over their mesh axis); the partial outputs are summed by the
redistribute back to the residual's placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from ..sharding.specs import (active_mesh, active_rules, is_dtensor,
                              placements_for)
from .config import ModelConfig
from . import dense, layers as L

CAPACITY_FACTOR = 1.25


def moe_mlp_spec(cfg: ModelConfig) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": L.Leaf((d, e), ("embed", "experts")),
        "wg": L.Leaf((e, d, fe), ("experts", "embed_fsdp", "expert_ff")),
        "wu": L.Leaf((e, d, fe), ("experts", "embed_fsdp", "expert_ff")),
        "wd": L.Leaf((e, fe, d), ("experts", "expert_ff", "embed_fsdp")),
    }


def block_spec(cfg: ModelConfig) -> dict:
    return {
        "pre_attn": L.norm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "pre_mlp": L.norm_spec(cfg.d_model),
        "moe": moe_mlp_spec(cfg),
    }


def model_spec(cfg: ModelConfig) -> dict:
    spec = dict(L.embed_spec(cfg))
    spec["blocks"] = [block_spec(cfg) for _ in range(cfg.n_layers)]
    spec["final_norm"] = L.norm_spec(cfg.d_model)
    return spec


def capacity(cfg: ModelConfig, tokens: int) -> int:
    return max(int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                             * CAPACITY_FACTOR)), 1)


def route(router, cfg: ModelConfig, xt):
    """xt: (T, D). The dispatch of ``moe_mlp``: a dict of the router's
    ``probs`` (T, E), the sorted rows' expert ``se``, token ``st`` and gate
    ``sg``, ``keep`` (which sorted rows fit their expert's capacity),
    ``slot`` (each kept row's place in the (E*C,) buffer; E*C for a
    dropped row), ``counts`` (E,) and ``C``."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    # routing in fp32: the JAX package promotes x @ router.astype(f32)
    logits = xt.float() @ router.float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_idx = top_logits[:, :K], top_idx[:, :K]
    gates = torch.softmax(top_logits, dim=-1).to(xt.dtype)
    flat_e = top_idx.reshape(T * K)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], gates.reshape(T * K)[order]
    counts = torch.zeros(E, dtype=flat_e.dtype, device=xt.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=xt.device) - offsets[se]
    C = capacity(cfg, T)
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)
    return dict(probs=probs, se=se, st=st, sg=sg, keep=keep, slot=slot,
                counts=counts, C=C)


def moe_mlp(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss)."""
    if active_mesh() is not None and is_dtensor(x):
        return _moe_mlp_mesh(p, cfg, x)
    return _moe_experts(cfg, x, p.router, p.wg, p.wu, p.wd, 0)


def _moe_experts(cfg: ModelConfig, x, router, wg, wu, wd, e0: int):
    """``moe_mlp`` over experts e0 .. e0 + len(wg) of the routing of all of
    x's tokens; the other experts' rows contribute nothing to y.

    Spans: ``rt.moe.route``, ``rt.moe.pack``, ``rt.moe.experts``,
    ``rt.moe.combine``; in the backward ``rt.moe.bwd`` (the block) with
    ``rt.moe.experts.bwd`` (the expert products) inside it. Under
    ``obs.trace.device_ranges`` the counters ``moe.rows_routed`` (T*K),
    ``moe.rows_kept`` (the rows that fit a local expert's capacity, a 0-d
    tensor summed on the device) and ``moe.slots`` (El*C) add up."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    El = wg.shape[0]
    bwd = obs_trace.backward_range("rt.moe.bwd")
    x, router, wg, wu, wd = bwd.close_at(x, router, wg, wu, wd)
    with obs_trace.span("rt.moe.route"):
        xt = x.reshape(T, D)
        r = route(router, cfg, xt)
        C, keep, slot, st = r["C"], r["keep"], r["slot"], r["st"]
        local = keep & (r["se"] >= e0) & (r["se"] < e0 + El)
        slot = torch.where(local, slot - e0 * C, El * C)
    if obs_trace.ranges_on():
        REGISTRY.counter("moe.rows_routed").inc(T * K)
        REGISTRY.counter("moe.rows_kept").inc(local.sum())
        REGISTRY.counter("moe.slots").inc(El * C)

    with obs_trace.span("rt.moe.pack"):
        # dropped rows all land in the overflow row El*C, which is cut off
        buf = torch.zeros((El * C + 1, D), dtype=x.dtype, device=x.device)
        buf[slot] = xt[st]
        buf = L.constrain(buf[:-1].reshape(El, C, D),
                          ("experts", None, "embed"))

    # expert computation (batched GEMM over the expert dim)
    ebwd = obs_trace.backward_range("rt.moe.experts.bwd")
    buf, wg, wu, wd = ebwd.close_at(buf, wg, wu, wd)
    with obs_trace.span("rt.moe.experts"):
        h = torch.bmm(buf, wg.to(x.dtype))
        u = torch.bmm(buf, wu.to(x.dtype))
        h = L.constrain(F.silu(h) * u, ("experts", None, "expert_ff"))
        out = L.constrain(torch.bmm(h, wd.to(x.dtype)),
                          ("experts", None, "embed"))
    out = ebwd.open_at(out)

    with obs_trace.span("rt.moe.combine"):
        rows = out.reshape(El * C, D)
        gathered = torch.where(local[:, None],
                               rows[slot.clamp(0, El * C - 1)],
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device))
        y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
        y.index_add_(0, st, gathered * r["sg"][:, None])

        # auxiliary load-balance loss
        frac = r["counts"].float() / (T * K)
        aux = E * torch.sum(frac * r["probs"].mean(0)) * cfg.aux_loss_coef
        y = L.constrain(y.reshape(B, S, D), ("batch", "seq", "embed"))
    return bwd.open_at(y, aux)


def _moe_mlp_mesh(p, cfg: ModelConfig, x):
    """``moe_mlp`` on local shards: the tokens gathered on every rank, the
    router replicated, each rank's experts (the ``experts`` rule's shard,
    their other dims gathered). y comes back as a partial sum over the
    experts' mesh dims, reduced by the constrain to the residual's
    placements, and so do the gradients of x and of the router. The aux
    loss, which every rank computes whole, is returned as a partial sum of
    its 1/n (n ranks over the experts' dims), so that its gradient is
    counted once."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = active_mesh()
    e_pl = placements_for(mesh, active_rules().spec_for(("experts",)))
    e_dims = [i for i, pl in enumerate(e_pl) if pl.is_shard()]
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in e_dims else Replicate()
                 for i in range(mesh.ndim))
    n = 1
    for i in e_dims:
        n *= mesh.size(i)

    def local(xl, router, wg, wu, wd):
        r = 0
        for i in e_dims:
            r = r * mesh.size(i) + mesh.get_local_rank(i)
        y, aux = _moe_experts(cfg, xl, router, wg, wu, wd,
                              r * -(-cfg.n_experts // n))
        return y, aux / n

    y, aux = local_map(local, out_placements=(part, part),
                       in_placements=(rep, rep, e_pl, e_pl, e_pl),
                       in_grad_placements=(part, part, e_pl, e_pl, e_pl),
                       device_mesh=mesh, redistribute_inputs=True)(
        x, p.router, p.wg, p.wu, p.wd)
    return L.constrain(y, ("batch", "seq", "embed")), aux


def _apply_block(p, cfg, x, positions, angles, role):
    h, _ = L.attention(p.attn, cfg, L.rmsnorm(x, p.pre_attn, cfg.norm_eps),
                       positions, causal=True,
                       window=cfg.window if role == "local" else 0,
                       angles=angles)
    x = x + h
    y, aux = moe_mlp(p.moe, cfg, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return x + y, aux


def forward(model, tokens, positions=None, return_hidden=False):
    """Returns (logits or the final normed hidden state,
    {"aux_loss": fp32 scalar summed over layers})."""
    cfg = model.cfg
    B, S = tokens.shape
    x = L.embed(model, cfg, tokens)
    pos = torch.arange(S, device=x.device) if positions is None \
        else positions
    angles = L.rope_angles(pos[None].expand(B, S), cfg.hd, cfg.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, blk in enumerate(model.blocks):
        x, aux = L.remat_call(cfg, _apply_block, blk, cfg, x, positions,
                              angles, dense.layer_role(cfg, layer))
        aux_total = aux_total + aux
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, {"aux_loss": aux_total}
    return L.unembed(model, cfg, x), {"aux_loss": aux_total}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

init_cache = dense.init_cache   # one (k, v) pair per layer


def decode_step(model, cache: list, token, pos: int):
    cfg = model.cfg
    x = L.embed(model, cfg, token)
    new_cache = []
    for layer, (p, (ck, cv)) in enumerate(zip(model.blocks, cache)):
        role = dense.layer_role(cfg, layer)
        h = L.rmsnorm(x, p.pre_attn, cfg.norm_eps)
        h, ck, cv = L.attention_decode(
            p.attn, cfg, h, ck, cv, pos,
            window=cfg.window if role == "local" else 0)
        x = x + h
        y, _ = moe_mlp(p.moe, cfg, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
        x = x + y
        new_cache.append((ck, cv))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), new_cache

"""RecurrentGemma / Griffin hybrid family: RG-LRU recurrent blocks
interleaved with local sliding-window attention (arXiv:2402.19427).

The pattern ("recurrent", "recurrent", "local") repeats; the remainder
layers (26 % 3 == 2 for recurrentgemma-2b) are the JAX package's unscanned
tail, here simply layers 24 and 25, each with its pattern role.

The RG-LRU recurrence h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t*x_t) is a
linear scan over the sequence. JAX computes it with
``lax.associative_scan``; the port uses a log-depth (Hillis-Steele) scan
of the same combine, ceil(log2 S) steps of whole-sequence tensor ops, in
fp32, cast back to the recurrence's dtype. Decode is an O(1) update.

dtypes follow the JAX package's promotions: the gates and the scan run in
the model dtype (bf16 at full width), the decode state is fp32, so a
decode step's hidden state and its product with the gate are fp32 until
the output projection is cast back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.specs import local_region
from .config import ModelConfig
from . import dense, layers as L


C_COEF = 8.0  # Griffin's `c` constant
CONV = 4      # the RG-LRU's causal conv width


def rglru_spec(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "norm": L.norm_spec(d),
        "in_x": L.Leaf((d, w), ("embed_fsdp", "ff")),
        "in_gate": L.Leaf((d, w), ("embed_fsdp", "ff")),
        "conv_w": L.Leaf((CONV, w), ("conv", "ff")),
        "conv_b": L.Leaf((w,), ("ff",), scale=0.0),
        "w_input_gate": L.Leaf((w, w), (None, "ff")),
        "w_rec_gate": L.Leaf((w, w), (None, "ff")),
        "lambda_p": L.Leaf((w,), ("ff",), scale=-1.0),
        "out": L.Leaf((w, d), ("ff", "embed_fsdp")),
    }


def block_spec(cfg: ModelConfig, role: str) -> dict:
    base = {"pre_mlp": L.norm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg, geglu=True)}
    if role == "recurrent":
        base["rglru"] = rglru_spec(cfg)
    else:
        base["pre_attn"] = L.norm_spec(cfg.d_model)
        base["attn"] = L.attn_spec(cfg)
    return base


def model_spec(cfg: ModelConfig) -> dict:
    spec = dict(L.embed_spec(cfg))
    spec["blocks"] = [block_spec(cfg, dense.layer_role(cfg, layer))
                      for layer in range(cfg.n_layers)]
    spec["final_norm"] = L.norm_spec(cfg.d_model)
    return spec


def rglru_scan(a, bx):
    """h_t = a_t * h_{t-1} + bx_t, h_{-1} = 0; a, bx: (B, S, W).

    Hillis-Steele: after the step of stride d, (a_t, b_t) holds the
    composition of the d' <= 2d steps ending at t, combined as
    ``lax.associative_scan``'s combine((al, bl), (ar, br)) = (al*ar,
    ar*bl + br). Computed in fp32, returned in bx's dtype."""
    dt = bx.dtype
    a, b = a.float(), bx.float()
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b.to(dt)


# on a mesh: per batch row and channel on local shards (the scan's and
# the conv's sequence shifts have no DTensor rule in every torch version)
_conv_region = local_region(
    L.causal_conv, in_axes=(("batch", None, "act_ff"), ("conv", "ff"), ("ff",)),
    out_axes=("batch", None, "act_ff"))
_scan_region = local_region(
    rglru_scan, in_axes=(("batch", None, "act_ff"),) * 2,
    out_axes=("batch", None, "act_ff"))


def rglru_block(p, cfg: ModelConfig, x, state=None, conv_state=None,
                decode=False):
    """Returns (y, new_state, new_conv_state); new_conv_state is None in
    prefill."""
    h = L.seq_gathered(L.rmsnorm(x, p.norm, cfg.norm_eps))
    gate = F.gelu(h @ p.in_gate, approximate="tanh")   # jax.nn.gelu's default
    u = h @ p.in_x
    # causal depthwise conv (window 4)
    if decode:
        win = torch.cat([conv_state, u.to(conv_state.dtype)], dim=1)
        u = torch.einsum("bkc,kc->bc", win, p.conv_w)[:, None] + p.conv_b
        new_conv = win[:, 1:]
    else:
        u = _conv_region(u, p.conv_w, p.conv_b)
        new_conv = None
    # RG-LRU
    i_t = torch.sigmoid(u @ p.w_input_gate)
    r_t = torch.sigmoid(u @ p.w_rec_gate)
    log_a = -C_COEF * r_t * F.softplus(p.lambda_p)
    a_t = torch.exp(log_a)
    scaled = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    bx = scaled * (i_t * u)
    if decode:
        new_state = (a_t[:, 0] * state + bx[:, 0]).float()
        hidden = new_state[:, None]
    else:
        hidden = _scan_region(a_t, bx)
        new_state = hidden[:, -1].float()
    y = L.residual_branch(((hidden * gate) @ p.out.to(hidden.dtype))
                          .to(x.dtype))
    return y, new_state, new_conv


def _apply_block(p, cfg, x, role, positions, angles):
    if role == "recurrent":
        y, _, _ = rglru_block(p.rglru, cfg, x)
        x = x + y
    else:
        h, _ = L.attention(p.attn, cfg,
                           L.rmsnorm(x, p.pre_attn, cfg.norm_eps),
                           positions, causal=True, window=cfg.window,
                           angles=angles)
        x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return L.constrain(x, ("batch", "seq", "embed"))


def forward(model, tokens, positions=None, return_hidden=False):
    """Returns (logits or the final normed hidden state, None)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = L.embed(model, cfg, tokens)
    pos = torch.arange(S, device=x.device) if positions is None \
        else positions
    angles = L.rope_angles(pos[None].expand(B, S), cfg.hd, cfg.rope_theta)
    for layer, blk in enumerate(model.blocks):
        x = L.remat_call(cfg, _apply_block, blk, cfg, x,
                         dense.layer_role(cfg, layer), positions, angles)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, None
    return L.unembed(model, cfg, x), None


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> list:
    """Per layer: {"state" (B, W) fp32, "conv" (B, 3, W)} for a recurrent
    layer, {"k", "v"} (B, min(window, max_seq), KV, hd) for a local one."""
    cache = []
    for layer in range(cfg.n_layers):
        if dense.layer_role(cfg, layer) == "recurrent":
            cache.append({
                "state": torch.zeros((batch, cfg.lru_width),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, CONV - 1, cfg.lru_width),
                                    dtype=cfg.torch_dtype, device=device)})
        else:
            shape = (batch, min(cfg.window, max_seq), cfg.n_kv_heads, cfg.hd)
            cache.append({k: torch.zeros(shape, dtype=cfg.torch_dtype,
                                         device=device) for k in "kv"})
    return cache


def _decode_block(p, cfg, x, c, role, pos):
    if role == "recurrent":
        y, ns, ncv = rglru_block(p.rglru, cfg, x, state=c["state"],
                                 conv_state=c["conv"], decode=True)
        x = x + y
        nc = {"state": ns, "conv": ncv}
    else:
        h = L.rmsnorm(x, p.pre_attn, cfg.norm_eps)
        h, ck, cv = L.attention_decode(p.attn, cfg, h, c["k"], c["v"], pos,
                                       window=cfg.window)
        x = x + h
        nc = {"k": ck, "v": cv}
    x = x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return x, nc


def decode_step(model, cache: list, token, pos: int):
    cfg = model.cfg
    x = L.embed(model, cfg, token)
    new_cache = []
    for layer, (blk, c) in enumerate(zip(model.blocks, cache)):
        x, nc = _decode_block(blk, cfg, x, c, dense.layer_role(cfg, layer),
                              pos)
        new_cache.append(nc)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), new_cache

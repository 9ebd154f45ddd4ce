"""Mamba2 (state-space duality / SSD) family — attention-free.

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060), as the JAX package
computes it: within a chunk the semiseparable matrix is applied
quadratically (einsums), across chunks a linear recurrence on the
(H, N, P) state runs, here as a Python loop over the chunks where JAX has
``lax.scan``. Parallel prefill needs S to be a multiple of ``ssm_chunk``.
Decode is O(1): one state update a token.

dtypes follow the JAX package's promotions, written out where torch would
raise or round otherwise: the decay terms are fp32 (``A`` is), so the
chunk einsums run in fp32 and the block's output before ``out_proj`` is
fp32 in prefill; decode's state update is fp32 and its read-out in the
model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.specs import local_region
from .config import ModelConfig
from . import layers as L


def block_spec(cfg: ModelConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    conv_ch = din + 2 * N   # x plus single-group B and C
    return {
        "norm": L.norm_spec(d),
        "in_proj": L.Leaf((d, 2 * din + 2 * N + H), ("embed_fsdp", "heads")),
        "conv_w": L.Leaf((cfg.ssm_conv, conv_ch), ("conv", "heads")),
        "conv_b": L.Leaf((conv_ch,), ("heads",), scale=0.0),
        "A_log": L.Leaf((H,), ("heads",), scale=-1.0),
        "D": L.Leaf((H,), ("heads",), scale=-1.0),
        "dt_bias": L.Leaf((H,), ("heads",), scale=0.0),
        "out_norm": L.Leaf((din,), ("heads",), scale=0.0),
        "out_proj": L.Leaf((din, d), ("heads", "embed_fsdp")),
    }


def model_spec(cfg: ModelConfig) -> dict:
    spec = dict(L.embed_spec(cfg))
    spec["blocks"] = [block_spec(cfg) for _ in range(cfg.n_layers)]
    spec["final_norm"] = L.norm_spec(cfg.d_model)
    return spec


# on a mesh: per batch row and channel on local shards (a DTensor pad of
# the sequence has no rule in every torch version)
_conv_region = local_region(
    L.causal_conv, in_axes=(("batch", None, "heads"), ("conv", "heads"),
                           ("heads",)),
    out_axes=("batch", None, "heads"))


def _split_proj(cfg, proj):
    din, N = cfg.d_inner, cfg.ssm_state
    z = proj[..., :din]
    xBC = proj[..., din:2 * din + 2 * N]
    dt = proj[..., 2 * din + 2 * N:]
    return z, xBC, dt


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan from a zero state. x: (B,S,H,P), dt: (B,S,H)
    (post-softplus), A: (H,) < 0 fp32, Bm/Cm: (B,S,N). Returns y
    (B,S,H,P) fp32."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    xdt = (xc * dtc[..., None]).to(f32)             # (b,c,q,h,p)
    dA = dtc.to(f32) * A                            # (b,c,q,h) negative
    cs = torch.cumsum(dA, dim=2)                    # within-chunk cumsum

    # intra-chunk (quadratic within the chunk). The segment sums above the
    # diagonal are masked before the exp, not after as the JAX package
    # does: there they grow with the chunk's decay, and where exp overflows
    # to inf its gradient, 0 * inf, is NaN. The values are the same.
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None],
                                 cs[:, :, :, None, :] - cs[:, :, None, :, :],
                                 float("-inf")))           # (b,c,q,t,h)
    CB = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)    # model dtype, as in JAX
    y_diag = torch.einsum("bcqt,bcqth,bcthp->bcqhp", CB.to(f32), Lmat, xdt)

    # chunk states + inter-chunk recurrence
    decay_out = torch.exp(cs[:, :, -1:, :] - cs)    # (b,c,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.to(f32), decay_out,
                          xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])        # (b,c,h)
    S = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    S_prev = []
    for c in range(nc):
        S_prev.append(S)                            # the state *before*
        S = S * chunk_decay[:, c, :, None, None] + states[:, c]
    S_prev = torch.stack(S_prev, dim=1)             # (b,c,h,n,p)

    decay_in = torch.exp(cs)                        # (b,c,q,h)
    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc.to(f32), S_prev,
                         decay_in)
    return (y_diag + y_off).reshape(b, s, h, p)


# on a mesh: per batch row and head on local shards (DTensor has no rule
# for the chunk loop's ops on sharded heads)
_ssd_region = local_region(
    ssd_chunked,
    in_axes=(("batch", None, "heads", None), ("batch", None, "heads"),
             ("heads",), ("batch", None, None), ("batch", None, None), None),
    out_axes=("batch", None, "heads", None))


def _apply_block(p, cfg, x):
    B, S, D = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = L.seq_gathered(L.rmsnorm(x, p.norm, cfg.norm_eps))
    proj = h @ p.in_proj
    z, xBC, dt = _split_proj(cfg, proj)
    xBC = F.silu(_conv_region(xBC, p.conv_w, p.conv_b))
    xs = xBC[..., :din].reshape(B, S, H, P)
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]
    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    y = _ssd_region(xs, dt, A, Bm, Cm, cfg.ssm_chunk)      # fp32
    y = y + xs * p.D[None, None, :, None]
    y = y.reshape(B, S, din) * F.silu(z)
    y = L.rmsnorm(y, p.out_norm, cfg.norm_eps)
    return x + L.residual_branch((y @ p.out_proj.to(y.dtype)).to(x.dtype))


def forward(model, tokens, positions=None, return_hidden=False):
    """S must be a multiple of ``ssm_chunk``; positions play no part (no
    attention, no RoPE), as in the JAX package. Returns (logits or the final
    normed hidden state, None)."""
    cfg = model.cfg
    x = L.embed(model, cfg, tokens)
    for blk in model.blocks:
        x = L.remat_call(cfg, _apply_block, blk, cfg, x)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, None
    return L.unembed(model, cfg, x), None


# ---------------------------------------------------------------------------
# Decode: O(1) state update per token
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> list:
    """Per layer, (ssm_state (B, H, N, P) fp32, conv_state (B, conv-1, C))."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * N
    return [(torch.zeros((batch, H, N, P), dtype=torch.float32,
                         device=device),
             torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=cfg.torch_dtype, device=device))
            for _ in range(cfg.n_layers)]


def _decode_block(p, cfg, x, S_state, conv_state):
    B = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = L.rmsnorm(x, p.norm, cfg.norm_eps)
    proj = (h @ p.in_proj)[:, 0]                    # (B, ...)
    z, xBC, dt = _split_proj(cfg, proj)
    # conv: window = [conv_state ; xBC]
    win = torch.cat([conv_state, xBC[:, None, :]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", win, p.conv_w) + p.conv_b)
    new_conv = win[:, 1:]
    xs = conv_out[..., :din].reshape(B, H, P)
    Bm = conv_out[..., din:din + N]
    Cm = conv_out[..., din + N:]
    dtv = F.softplus(dt + p.dt_bias)                # (B, H)
    A = -torch.exp(p.A_log.float())
    dA = torch.exp(dtv.float() * A)                 # (B, H) fp32
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm, dtv, xs)
    S_new = S_state * dA[:, :, None, None] + upd    # fp32
    y = torch.einsum("bn,bhnp->bhp", Cm, S_new.to(Cm.dtype))
    y = y + xs * p.D[None, :, None]
    y = y.reshape(B, 1, din) * F.silu(z)[:, None]
    y = L.rmsnorm(y, p.out_norm, cfg.norm_eps)
    return x + y @ p.out_proj, S_new, new_conv


def decode_step(model, cache: list, token, pos: int):
    cfg = model.cfg
    x = L.embed(model, cfg, token)      # (B, 1, D)
    new_cache = []
    for blk, (S_state, conv_state) in zip(model.blocks, cache):
        x, S_state, conv_state = _decode_block(blk, cfg, x, S_state,
                                               conv_state)
        new_cache.append((S_state, conv_state))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), new_cache

"""Encoder-decoder (Whisper) family — transformer backbone only.

The mel-spectrogram + conv frontend is a stub, as in the JAX package: the
model takes precomputed frame embeddings (B, frames, D). The encoder is
bidirectional; the decoder has causal self-attention plus cross-attention
over the encoder states. Sinusoidal positional embeddings (no RoPE),
biases on (whisper-style).

Kernels: every RMSNorm goes to K1; the encoder's self-attention (not
causal) and the decoder's (causal) go to K2; cross-attention (keys from
the encoder, Sk != S) keeps the plain path.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from . import layers as L


def _enc_block_spec(cfg) -> dict:
    return {
        "pre_attn": L.norm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "pre_mlp": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg, geglu=False),
    }


def _dec_block_spec(cfg) -> dict:
    return {
        "pre_self": L.norm_spec(cfg.d_model),
        "self_attn": L.attn_spec(cfg),
        "pre_cross": L.norm_spec(cfg.d_model),
        "cross_attn": L.attn_spec(cfg),
        "pre_mlp": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg, geglu=False),
    }


def model_spec(cfg: ModelConfig) -> dict:
    spec = dict(L.embed_spec(cfg))
    spec["enc_blocks"] = [_enc_block_spec(cfg)
                          for _ in range(cfg.encoder_layers)]
    spec["dec_blocks"] = [_dec_block_spec(cfg) for _ in range(cfg.n_layers)]
    spec["enc_norm"] = L.norm_spec(cfg.d_model)
    spec["final_norm"] = L.norm_spec(cfg.d_model)
    return spec


def sinusoid(S: int, d: int, dtype, device=None):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encode(model, frames):
    """frames: (B, F, D) precomputed frontend embeddings (stub)."""
    cfg = model.cfg
    B, Fr, D = frames.shape
    x = frames.to(cfg.torch_dtype) \
        + sinusoid(Fr, D, cfg.torch_dtype, frames.device)[None]
    for blk in model.enc_blocks:
        h, _ = L.attention(blk.attn, cfg,
                           L.rmsnorm(x, blk.pre_attn, cfg.norm_eps),
                           causal=False)
        x = x + h
        x = x + L.mlp(blk.mlp, L.rmsnorm(x, blk.pre_mlp, cfg.norm_eps))
        x = L.constrain(x, ("batch", "seq", "embed"))
    return L.rmsnorm(x, model.enc_norm, cfg.norm_eps)


def _dec_block(p, cfg, x, enc, positions):
    h, _ = L.attention(p.self_attn, cfg,
                       L.rmsnorm(x, p.pre_self, cfg.norm_eps),
                       positions, causal=True)
    x = x + h
    h, _ = L.attention(p.cross_attn, cfg,
                       L.rmsnorm(x, p.pre_cross, cfg.norm_eps),
                       positions, causal=False, kv_override=enc)
    x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return L.constrain(x, ("batch", "seq", "embed"))


def forward(model, tokens, frames, positions=None, return_hidden=False):
    """Teacher-forced prefill: returns (logits or the final normed hidden
    state, None). ``positions`` only masks the decoder's self-attention:
    the sinusoid is added at 0..S-1, as in the JAX package."""
    cfg = model.cfg
    B, S = tokens.shape
    enc = encode(model, frames)
    x = L.take_rows(model.embed, tokens).to(cfg.torch_dtype)
    x = x + sinusoid(S, cfg.d_model, cfg.torch_dtype, x.device)[None]
    for blk in model.dec_blocks:
        x = L.remat_call(cfg, _dec_block, blk, cfg, x, enc, positions)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, None
    return L.unembed(model, cfg, x), None


# ---------------------------------------------------------------------------
# Decode: self-attn cache + per-layer cached cross K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """{"self": per layer (k, v) (B, max_seq, KV, hd), "cross": per layer
    (k, v) (B, encoder_frames, KV, hd)}, zeros; ``build_cross_cache`` fills
    "cross" from the encoder's states."""
    def zeros(C):
        return torch.zeros((batch, C, cfg.n_kv_heads, cfg.hd),
                           dtype=cfg.torch_dtype, device=device)
    return {"self": [(zeros(max_seq), zeros(max_seq))
                     for _ in range(cfg.n_layers)],
            "cross": [(zeros(cfg.encoder_frames), zeros(cfg.encoder_frames))
                      for _ in range(cfg.n_layers)]}


def build_cross_cache(model, enc) -> list:
    """Per-layer cross-attention (k, v) from the encoder states."""
    cfg = model.cfg
    B, Fr, D = enc.shape
    out = []
    for blk in model.dec_blocks:
        p = blk.cross_attn
        k = (enc @ p.wk).reshape(B, Fr, cfg.n_kv_heads, cfg.hd)
        v = (enc @ p.wv).reshape(B, Fr, cfg.n_kv_heads, cfg.hd)
        if cfg.use_bias:
            v = v + p.bv.reshape(1, 1, cfg.n_kv_heads, cfg.hd)
        out.append((k, v))
    return out


def decode_step(model, cache: dict, token, pos: int):
    cfg = model.cfg
    B = token.shape[0]
    x = L.take_rows(model.embed, token).to(cfg.torch_dtype)
    max_seq = cache["self"][0][0].shape[1]
    x = x + sinusoid(max_seq, cfg.d_model, cfg.torch_dtype,
                     x.device)[pos][None, None]
    new_self = []
    for blk, (sk, sv), (ck, cv) in zip(model.dec_blocks, cache["self"],
                                       cache["cross"]):
        h = L.rmsnorm(x, blk.pre_self, cfg.norm_eps)
        # sinusoid positions are added at the embedding; no RoPE anywhere
        # in this family's forward, so none in decode either
        h, sk, sv = L.attention_decode(blk.self_attn, cfg, h, sk, sv, pos,
                                       rope=False)
        x = x + h
        # cross attention against the cached encoder K/V (no mask)
        h = L.rmsnorm(x, blk.pre_cross, cfg.norm_eps)
        p = blk.cross_attn
        q = (h @ p.wq).reshape(B, 1, cfg.n_heads, cfg.hd)
        if cfg.use_bias:
            q = q + p.bq.reshape(1, 1, cfg.n_heads, cfg.hd)
        ones = torch.ones((1, 1, 1, ck.shape[1]), dtype=torch.bool,
                          device=x.device)
        y = L.gqa_attend(q, ck, cv, ones) @ p.wo
        if cfg.use_bias:
            y = y + p.bo
        x = x + y
        x = x + L.mlp(blk.mlp, L.rmsnorm(x, blk.pre_mlp, cfg.norm_eps))
        new_self.append((sk, sv))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), {"self": new_self,
                                      "cross": cache["cross"]}

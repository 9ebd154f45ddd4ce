"""Dense decoder-only transformer family (``dense`` and ``vlm``).

Covers gemma3-27b / gemma3-12b (5:1 local:global attention pattern),
yi-9b (llama arch), command-r-35b (no-bias GQA), qwen2-vl-2b (M-RoPE and a
stubbed vision frontend whose patch embeddings go through ``vision_proj``)
and the paper's GPT. The model has one submodule per layer (``blocks[l]``);
layer ``l`` plays the pattern role ``pattern[l % P]``. This is the JAX
package's layer order: its scanned stack holds layer ``g*P + i`` at
``blocks/p{i}[g]`` and the remainder layers under ``tail`` (see
``convert.py``). Per-layer KV caches are ring buffers for "local" layers
and linear for "global" ones, which keeps decode memory at the
architecture's true footprint.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from . import layers as L


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig) -> dict:
    return {
        "pre_attn": L.norm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "pre_mlp": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg, geglu=not cfg.use_bias),
    }


def model_spec(cfg: ModelConfig) -> dict:
    spec = dict(L.embed_spec(cfg))
    spec["blocks"] = [block_spec(cfg) for _ in range(cfg.n_layers)]
    spec["final_norm"] = L.norm_spec(cfg.d_model)
    if cfg.vision_tokens:
        spec["vision_proj"] = L.Leaf((cfg.d_model, cfg.d_model),
                                     ("embed", "embed_fsdp"))
    return spec


def layer_role(cfg: ModelConfig, layer: int) -> str:
    return cfg.pattern[layer % len(cfg.pattern)]


def _role_window(cfg, role):
    return cfg.window if role == "local" else 0


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, x, positions, angles, role):
    h, kv = L.attention(p.attn, cfg, L.rmsnorm(x, p.pre_attn, cfg.norm_eps),
                        positions, causal=True,
                        window=_role_window(cfg, role), angles=angles)
    x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return L.constrain(x, ("batch", "seq", "embed")), kv


def forward(model, tokens, positions=None, patch_embeds=None,
            collect_kv=False, return_hidden=False):
    """tokens: (B, S_text); patch_embeds: (B, V_tok, D) for the VLM family,
    put in front of the text; positions: (S,) over the whole sequence, None
    for 0..S-1. Returns (logits, or the final normed hidden state with
    ``return_hidden``; each layer's (k, v) with ``collect_kv``, else
    None)."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = L.embed(model, cfg, tokens)
    if cfg.vision_tokens and patch_embeds is not None:
        pe = patch_embeds.to(cfg.torch_dtype) @ model.vision_proj
        x = torch.cat([pe, x], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device) if positions is None \
        else positions
    if cfg.mrope:
        angles = L.rope_angles(pos[None, :, None].expand(B, S, 3), cfg.hd,
                               cfg.rope_theta, cfg.mrope_sections)
    else:
        angles = L.rope_angles(pos[None].expand(B, S), cfg.hd,
                               cfg.rope_theta)
    kvs = []
    for layer, blk in enumerate(model.blocks):
        x, kv = L.remat_call(cfg, _apply_block, blk, cfg, x, positions,
                             angles, layer_role(cfg, layer))
        kvs.append(kv)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    kvs = kvs if collect_kv else None
    if return_hidden:
        return x, kvs
    logits = L.unembed(model, cfg, x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / 30.0) * 30.0
    return logits, kvs


# ---------------------------------------------------------------------------
# Decode (single token against per-layer caches)
# ---------------------------------------------------------------------------

def cache_size(cfg: ModelConfig, role: str, max_seq: int) -> int:
    return min(cfg.window, max_seq) if role == "local" else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> list:
    """One (k, v) pair per layer, each (B, C_layer, KV, hd), zeros."""
    cache = []
    for layer in range(cfg.n_layers):
        C = cache_size(cfg, layer_role(cfg, layer), max_seq)
        shape = (batch, C, cfg.n_kv_heads, cfg.hd)
        cache.append((torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                      torch.zeros(shape, dtype=cfg.torch_dtype, device=device)))
    return cache


def _decode_block(p, cfg, x, ck, cv, pos, role):
    h = L.rmsnorm(x, p.pre_attn, cfg.norm_eps)
    h, ck, cv = L.attention_decode(p.attn, cfg, h, ck, cv, pos,
                                   window=_role_window(cfg, role))
    x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))
    return x, ck, cv


def decode_step(model, cache: list, token, pos: int):
    """token: (B, 1) int; pos: int. Returns (logits (B, 1, vocab), cache);
    the caches are updated in place. As in the JAX package, decode applies
    no final-logit softcap and plain (not M-) RoPE."""
    cfg = model.cfg
    x = L.embed(model, cfg, token)
    new_cache = []
    for layer, (blk, (ck, cv)) in enumerate(zip(model.blocks, cache)):
        x, ck, cv = _decode_block(blk, cfg, x, ck, cv, pos,
                                  layer_role(cfg, layer))
        new_cache.append((ck, cv))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), new_cache

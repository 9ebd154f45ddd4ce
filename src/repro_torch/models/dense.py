"""Dense decoder-only transformer family.

Covers yi-9b (llama arch), gemma3 (5:1 local:global attention pattern) and
the paper's GPT. The model is an ``nn.Module`` with one submodule per layer
(``blocks[l]``); layer ``l`` plays the pattern role ``pattern[l % P]``.
This is the JAX package's layer order: its scanned stack holds layer
``g*P + i`` at ``blocks/p{i}[g]`` and the remainder layers under ``tail``
(see ``convert.py``). Per-layer KV caches are ring buffers for "local"
layers and linear for "global" ones, which keeps decode memory at the
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
    return spec


def layer_role(cfg: ModelConfig, layer: int) -> str:
    return cfg.pattern[layer % len(cfg.pattern)]


def _role_window(cfg, role):
    return cfg.window if role == "local" else 0


class DenseLM(L.Params):
    """The dense decoder: ``embed``, ``blocks[0..n_layers)``, ``final_norm``
    and (untied) ``unembed``. Weights are allocated uninitialised; build it
    through ``registry.init_params`` or ``convert.from_jax``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(model_spec(cfg), cfg.torch_dtype, device)
        self.cfg = cfg

    def forward(self, tokens):
        return forward(self, tokens)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, x, angles, role):
    h = L.attention(p.attn, cfg, L.rmsnorm(x, p.pre_attn, cfg.norm_eps),
                    window=_role_window(cfg, role), angles=angles)
    x = x + h
    return x + L.mlp(p.mlp, L.rmsnorm(x, p.pre_mlp, cfg.norm_eps))


def forward(model: DenseLM, tokens):
    """tokens: (B, S) int at positions 0..S-1 -> logits (B, S, vocab)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = L.embed(model, cfg, tokens)
    pos = torch.arange(S, device=tokens.device)
    angles = L.rope_angles(pos[None].expand(B, S), cfg.hd, cfg.rope_theta)
    for layer, blk in enumerate(model.blocks):
        x = _apply_block(blk, cfg, x, angles, layer_role(cfg, layer))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = L.unembed(model, cfg, x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / 30.0) * 30.0
    return logits


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


def decode_step(model: DenseLM, cache: list, token, pos: int):
    """token: (B, 1) int; pos: int. Returns (logits (B, 1, vocab), cache);
    the caches are updated in place."""
    cfg = model.cfg
    x = L.embed(model, cfg, token)
    new_cache = []
    for layer, (blk, (ck, cv)) in enumerate(zip(model.blocks, cache)):
        x, ck, cv = _decode_block(blk, cfg, x, ck, cv, pos,
                                  layer_role(cfg, layer))
        new_cache.append((ck, cv))
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model, cfg, x), new_cache

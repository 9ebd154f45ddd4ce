"""Serving: prefill + batched single-token decode."""
from __future__ import annotations

import torch

from ..models import encdec, registry
from ..obs import trace as obs_trace


@torch.no_grad()
def prefill_logits(model, batch: dict):
    """Parallel prefill: logits (B, S, vocab) for every prompt position.
    Span: ``rt.serve.prefill``."""
    with obs_trace.span("rt.serve.prefill"):
        logits, _ = registry.forward(model, batch)
    return logits


@torch.no_grad()
def sequential_prefill(model, tokens, max_seq: int, frames=None):
    """Build a KV cache by running decode_step over the prompt, one position
    at a time. Returns (cache, logits (B, S, vocab)).

    ``frames`` (encoder-decoder only): the encoder's input; the per-layer
    cross K/V is computed into the cache first, as decode_step expects."""
    B, S = tokens.shape
    cache = registry.init_cache(model, B, max_seq)
    if frames is not None:
        cache["cross"] = encdec.build_cross_cache(
            model, encdec.encode(model, frames))
    logits = []
    for i in range(S):
        lg, cache = registry.decode_step(model, cache, tokens[:, i:i + 1], i)
        logits.append(lg[:, 0])
    return cache, torch.stack(logits, dim=1)


@torch.no_grad()
def decode_tokens(model, cache, last_token, start_pos: int, n_steps: int,
                  temperature: float = 0.0, generator=None):
    """Greedy (argmax, as in JAX) or sampled generation of n_steps tokens.

    Sampling (``temperature > 0``) draws from ``generator``, a
    ``torch.Generator`` on the logits' device (seeded with 0 if None); its
    bits differ from ``jax.random``'s. Returns (cache, tokens (B, n_steps))."""
    tok = last_token
    out = []
    for i in range(n_steps):
        logits, cache = registry.decode_step(model, cache, tok, start_pos + i)
        logits = logits[:, 0]
        if temperature > 0.0:
            if generator is None:
                generator = torch.Generator(
                    device=logits.device).manual_seed(0)
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        tok = nxt[:, None]
        out.append(nxt)
    return cache, torch.stack(out, dim=1)

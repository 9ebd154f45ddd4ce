"""Input stand-ins for every (arch x input-shape) combo.

A stand-in (``sds``) is a tensor on the meta device: its shape and dtype,
no memory (the JAX package's ``ShapeDtypeStruct``); the dry run turns each
into a fake local shard. Decode shapes drive ``decode_step`` (one token +
KV cache of seq_len); train/prefill drive full-sequence compute. Modality
frontends are stubbed: ``frames`` / ``patch_embeds`` arrive as precomputed
embeddings. The dtypes are the JAX package's (int32 tokens).
"""
from __future__ import annotations

import torch

from ..models import dense, registry
from ..models.config import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401


def sds(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def skip_reason(cfg: ModelConfig, shape: InputShape):
    """Return a reason string if this (arch, shape) combination is skipped
    (documented in DESIGN.md), else None."""
    if shape.name == "long_500k":
        subq = (cfg.family in ("ssm", "hybrid") or cfg.window > 0)
        if not subq:
            return ("full-attention architecture: long_500k requires "
                    "sub-quadratic attention (DESIGN.md skip table)")
    return None


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Model-input specs for train/prefill modes."""
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        batch["tokens"] = sds((B, S - vt))
        batch["patch_embeds"] = sds((B, vt, cfg.d_model), torch.bfloat16)
    elif cfg.family == "audio":
        batch["tokens"] = sds((B, S))
        batch["frames"] = sds((B, cfg.encoder_frames, cfg.d_model),
                              torch.bfloat16)
    else:
        batch["tokens"] = sds((B, S))
    if shape.mode == "train":
        batch["labels"] = sds((B, S))
    return batch


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(cache_specs, token_spec, pos_spec) for decode shapes."""
    B, S = shape.global_batch, shape.seq_len
    cache = registry.init_cache(cfg, B, S, abstract=True)
    return cache, sds((B, 1)), sds((), torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    if shape.mode in ("train", "prefill"):
        return batch_specs(cfg, shape)
    cache, tok, pos = decode_specs(cfg, shape)
    return {"cache": cache, "token": tok, "pos": pos}


# ---------------------------------------------------------------------------
# Logical sharding axes for inputs/caches (mirrors the spec trees)
# ---------------------------------------------------------------------------

def batch_logical(cfg: ModelConfig, shape: InputShape) -> dict:
    out = {"tokens": ("batch", None)}
    if cfg.family == "vlm":
        out["patch_embeds"] = ("batch", None, "embed")
    if cfg.family == "audio":
        out["frames"] = ("batch", None, "embed")
    if shape.mode == "train":
        out["labels"] = ("batch", None)
    return out


def cache_logical(cfg: ModelConfig):
    """Logical axes matching the port's ``registry.init_cache`` structure:
    one entry a layer (the JAX package stacks the layers of a pattern
    position behind a ``"layers"`` axis instead)."""
    fam = cfg.family
    kv = ("batch", "kv_seq", "kv_heads", None)
    if fam in ("dense", "vlm", "moe"):
        return [(kv, kv) for _ in range(cfg.n_layers)]
    if fam == "ssm":
        return [(("batch", "heads", "state", None), ("batch", "conv", "ff"))
                for _ in range(cfg.n_layers)]
    if fam == "hybrid":
        return [{"state": ("batch", "ff"), "conv": ("batch", "conv", "ff")}
                if dense.layer_role(cfg, layer) == "recurrent"
                else {"k": kv, "v": kv} for layer in range(cfg.n_layers)]
    if fam == "audio":
        return {"self": [(kv, kv) for _ in range(cfg.n_layers)],
                "cross": [(kv, kv) for _ in range(cfg.n_layers)]}
    raise ValueError(fam)

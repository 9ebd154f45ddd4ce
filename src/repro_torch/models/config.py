"""Model configuration shared by all architecture families."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention pattern: cycled over layers, e.g. 5 local + 1 global (gemma3)
    # entries: "global" | "local" | "recurrent"
    pattern: tuple = ("global",)
    window: int = 0               # sliding-window size for "local" layers
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    use_bias: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    aux_loss_coef: float = 0.01

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2

    # hybrid (RG-LRU)
    lru_width: int = 0

    # encoder-decoder (whisper): encoder frames are a stubbed frontend
    encoder_layers: int = 0
    encoder_frames: int = 1500

    # VLM: stubbed vision frontend supplies patch embeddings
    vision_tokens: int = 0
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = False
    scan_layers: bool = True
    citation: str = ""

    # ---------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_reps(self) -> int:
        """Number of pattern-group repetitions."""
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers not divisible by pattern {self.pattern}"
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer attends over unbounded context (long_500k ok)."""
        return all(p != "global" for p in self.pattern) or self.family == "ssm"

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family (2 pattern groups,
        d_model<=256, <=4 experts)."""
        small = dict(
            n_layers=2 * len(self.pattern) if self.pattern else 2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 64) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            lru_width=min(self.lru_width, 128) if self.lru_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_frames=16 if self.encoder_layers else 1500,
            vision_tokens=8 if self.vision_tokens else 0,
            mrope_sections=(4, 6, 6) if self.mrope else self.mrope_sections,
            dtype="float32",
        )
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    """An assigned (seq_len, global_batch, mode) input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

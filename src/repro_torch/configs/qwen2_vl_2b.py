"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution (vision frontend stubbed to 1024
patch embeddings) [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128,
    pattern=("global",), window=0,
    vision_tokens=1024, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, tie_embeddings=True,
    citation="arXiv:2409.12191",
)

"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256,
    pattern=("local",) * 5 + ("global",), window=1024,
    rope_theta=1_000_000.0, tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt (family card, 12b variant)",
)

"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 2 recurrent : 1 attention
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256,
    pattern=("recurrent", "recurrent", "local"), window=2048,
    lru_width=2560, tie_embeddings=True,
    citation="arXiv:2402.19427",
)

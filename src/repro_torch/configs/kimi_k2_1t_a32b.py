"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per
expert) vocab=163840, 384 experts top-8 — trillion-param MoE
[arXiv:2501.kimi2, paper-table spec]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112,
    pattern=("global",), window=0,
    n_experts=384, top_k=8, moe_d_ff=2048,
    citation="arXiv:2501.kimi2 (paper-table)",
)

"""The paper's own evaluation model: GPT (Megatron-LM example scale)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=50257, head_dim=64,
    pattern=("global",), window=0, rope_theta=10_000.0,
    citation="Megatron-LM run_simple_mcore_train_loop (paper table 2)",
)

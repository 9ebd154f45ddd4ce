"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    pattern=("recurrent",),
    ssm_state=128, ssm_head_dim=64, ssm_chunk=256, ssm_conv=4, ssm_expand=2,
    citation="arXiv:2405.21060",
)

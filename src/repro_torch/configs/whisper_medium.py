"""whisper-medium [audio]: 24L (decoder) + 24L encoder, d_model=1024 16H
d_ff=4096 vocab=51865 — enc-dec, conv frontend stubbed to precomputed frame
embeddings [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, use_bias=True,
    pattern=("global",), window=0,
    encoder_layers=24, encoder_frames=1500, tie_embeddings=True,
    citation="arXiv:2212.04356",
)

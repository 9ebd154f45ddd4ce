"""Plain PyTorch oracles for the kernels, under the JAX package's names.

Each plain version lives in its kernel's own module; this module names
them as ``repro.kernels.ref`` does."""
from .flash_attention import flash_attention_plain as flash_attention_ref
from .rmsnorm import rmsnorm_plain as rmsnorm_ref

__all__ = ["flash_attention_ref", "rmsnorm_ref"]

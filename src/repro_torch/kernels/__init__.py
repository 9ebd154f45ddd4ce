"""Hand-written Hopper kernels for the model substrate's hot spots.

``rmsnorm`` (Triton) and ``flash_attention`` (CUDA C++, ``csrc/``) replace
the JAX package's two Pallas TPU kernels. Each module also holds the
kernel's plain PyTorch version; ``ops`` dispatches by device.
"""
from . import ops, ref

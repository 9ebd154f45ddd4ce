"""PyTorch/CUDA port of the model substrate, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package never imports it
(nor ``jax``). Modules mirror ``repro``'s layout: ``configs/``, ``models/``,
``kernels/`` and ``train/serve.py``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

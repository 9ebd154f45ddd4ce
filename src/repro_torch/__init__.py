"""PyTorch/CUDA port of the GraphGuard verifier and its model substrate,
for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package never imports it
(nor ``jax``). Modules mirror ``repro``'s layout: the verifier's main path
(``core/``, ``api/``, ``dist/strategies.py``, ``launch/verify.py``,
``obs/``), its runtime (``runtime/``: spawned supervised pool, certificate
cache, chaos) and the dense serving path (``configs/``, ``models/``,
``kernels/``, ``train/serve.py``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

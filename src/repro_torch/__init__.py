"""PyTorch/CUDA port of the ``repro`` model stack for NVIDIA Hopper (H100).

Each module mirrors its counterpart in the JAX package (``repro``), which
stays the reference: configs, kernels, models, serve, launch. The port
imports ``torch`` and ``numpy`` only; it never imports ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

"""Zipage on PyTorch and CUDA: the port of the JAX package ``repro``.

The public surface is ``repro_torch.api`` (``Zipage``, ``SamplingParams``).
Imports ``torch`` only — never ``jax`` and nothing of ``repro``.
"""

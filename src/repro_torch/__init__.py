"""PyTorch/CUDA port of the AVO reproduction, for an NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``repro_torch.core...``,
``repro_torch.kernels...``) and imports nothing of it and no JAX.
"""

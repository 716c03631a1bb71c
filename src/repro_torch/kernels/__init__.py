"""Kernels of the port: hand-written CUDA C++ for sm_90a (``csrc/``), each
beside its plain PyTorch version, plus the plain PyTorch oracles (``ref``)."""

"""Probe kernels: CUDA sources under ``csrc/``, their wrappers, their plain
PyTorch versions (``ref``) and the build (``build``)."""

"""Wrappers of the CUDA kernels in ``csrc/``, each beside its plain PyTorch version."""

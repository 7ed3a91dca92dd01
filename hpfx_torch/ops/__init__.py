"""Batched dense solves and their CUDA kernels."""

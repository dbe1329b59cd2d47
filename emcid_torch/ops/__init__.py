"""Attention (hand-written CUDA kernels with plain PyTorch versions) and the closed-form solve."""

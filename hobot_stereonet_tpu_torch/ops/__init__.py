"""Tensor ops of the port; ``kernels`` holds the hand-written CUDA kernels."""

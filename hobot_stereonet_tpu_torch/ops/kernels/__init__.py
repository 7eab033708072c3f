"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors.  ``build.launch_counts`` counts kernel launches.
"""

"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper calls a ``torch.library`` custom operator (``torch.ops.hst.*``,
defined beside it) whose CUDA implementation launches the kernel and whose
CPU implementation is the plain version, so that ``torch.export`` traces the
kernels into a program (``runtime/artifact.py``).  ``build.launch_counts``
counts kernel launches, inside the CUDA implementations.
"""

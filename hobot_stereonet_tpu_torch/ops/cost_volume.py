"""Correlation cost volume.

Counterpart of ``build_correlation_volume`` in
``hobot_stereonet_tpu/ops/cost_volume.py``.  The work is the correlation
kernel (``ops/kernels/correlation.py``): CUDA for CUDA tensors, its plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from .kernels.correlation import correlation_volume, correlation_volume_plain

__all__ = ["build_correlation_volume", "correlation_volume", "correlation_volume_plain"]


def build_correlation_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                             num_disparities: int) -> torch.Tensor:
    """[B,H,W,C] x2 -> [B,D,H,W] dot-product correlation volume, as the
    reference lays it out: a view of the kernel's channel-last output."""
    return correlation_volume(feat_l, feat_r, num_disparities).permute(0, 3, 1, 2)

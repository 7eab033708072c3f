"""Cost volumes.

Counterparts of ``hobot_stereonet_tpu/ops/cost_volume.py``:

  * :func:`build_correlation_volume` (the flagship's): the correlation
    kernel (``ops/kernels/correlation.py``), CUDA for CUDA tensors, its
    plain version for CPU tensors;
  * :func:`build_cost_volume` (the CLASSIC StereoNet's), ``difference`` or
    ``concat``, in plain PyTorch.  It is laid out [B, D, H, W, C] in
    memory, as the reference's, so that ``volume.permute(0, 4, 1, 2, 3)``
    is the NCDHW tensor the 3-D convs read in ``channels_last_3d`` memory,
    with no copy.
"""

from __future__ import annotations

import torch

from .kernels.correlation import correlation_volume, correlation_volume_plain

__all__ = ["build_correlation_volume", "build_cost_volume", "correlation_volume",
           "correlation_volume_plain", "shift_right_features"]


def shift_right_features(feat_r: torch.Tensor, d: int) -> torch.Tensor:
    """[..., W, C] -> the same with ``out[..., x, :] = feat_r[..., x - d, :]``,
    zero where ``x < d``."""
    if d == 0:
        return feat_r
    d = min(d, feat_r.shape[-2])
    out = torch.zeros_like(feat_r)
    out[..., d:, :] = feat_r[..., : feat_r.shape[-2] - d, :]
    return out


def build_cost_volume(feat_l: torch.Tensor, feat_r: torch.Tensor, num_disparities: int,
                      mode: str = "difference") -> torch.Tensor:
    """[B,H,W,C] x2 -> contiguous [B, D, H, W, C] (``difference``:
    ``feat_l - shift(feat_r, d)``) or [B, D, H, W, 2C] (``concat``:
    ``[feat_l, shift(feat_r, d)]``), in the features' dtype."""
    if mode not in ("difference", "concat"):
        raise ValueError(f"unknown cost mode {mode!r}")
    slices = []
    for d in range(num_disparities):
        shifted = shift_right_features(feat_r, d)
        slices.append(feat_l - shifted if mode == "difference"
                      else torch.cat([feat_l, shifted], -1))
    return torch.stack(slices, 1)


def build_correlation_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                             num_disparities: int) -> torch.Tensor:
    """[B,H,W,C] x2 -> [B,D,H,W] dot-product correlation volume, as the
    reference lays it out: a view of the kernel's channel-last output."""
    return correlation_volume(feat_l, feat_r, num_disparities).permute(0, 3, 1, 2)

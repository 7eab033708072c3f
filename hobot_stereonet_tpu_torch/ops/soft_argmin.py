"""Soft-argmin disparity regression and match confidence.

Counterpart of ``hobot_stereonet_tpu/ops/soft_argmin.py``.
:func:`soft_argmin` and :func:`disparity_confidence` take the cost and call
the plain version of the fused function.  The networks call the fused
kernels (``ops/kernels/correlation.py``), which apply the disparity scale:
``FastStereoNet`` :func:`soft_argmin_confidence` on channel-last logits
(``cost = -logits``), ``StereoNet`` :func:`soft_argmin_cost` on its
D-leading cost.
"""

from __future__ import annotations

import torch

from .kernels.correlation import (soft_argmin_confidence, soft_argmin_confidence_plain,
                                  soft_argmin_cost, soft_argmin_cost_plain)

__all__ = ["soft_argmin", "disparity_confidence", "soft_argmin_confidence",
           "soft_argmin_confidence_plain", "soft_argmin_cost", "soft_argmin_cost_plain"]


def soft_argmin(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Expected disparity ``sum_d d * softmax(-cost)_d`` in float32."""
    return soft_argmin_confidence_plain(-cost.movedim(dim, -1))[0]


def disparity_confidence(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Peak softmax probability, a per-pixel match confidence in [0, 1]."""
    return soft_argmin_confidence_plain(-cost.movedim(dim, -1))[1]

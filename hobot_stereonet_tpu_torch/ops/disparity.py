"""Disparity post-processing and accuracy metrics.

Counterpart of ``hobot_stereonet_tpu/ops/disparity.py``, on tensors (numpy
arrays are taken too, as CPU tensors).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CameraConfig

# Reference BPU output dequantization constants.
REFERENCE_DEQUANT_SCALE = 2.60443857769133e-6
REFERENCE_DISPARITY_MULTIPLIER = 16 * 12  # = 192


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def dequantize_reference_output(raw_int32, scale: float = REFERENCE_DEQUANT_SCALE
                                ) -> torch.Tensor:
    """int32 BPU tensor -> float disparity in px (``data * scale * 192``)."""
    return _t(raw_int32).float() * scale * REFERENCE_DISPARITY_MULTIPLIER


def disparity_to_depth_m(disparity_px: torch.Tensor,
                         camera: CameraConfig = CameraConfig()) -> torch.Tensor:
    """Float disparity (px) -> depth (m): ``Z = f*B / max(d, 1e-6) / 1000``."""
    return camera.depth_from_disparity(disparity_px)


def depth_to_disparity_px(depth_m, camera: CameraConfig = CameraConfig()) -> torch.Tensor:
    """Depth (m) -> disparity (px): ``f*B / max(Z, 1e-6) / 1000``."""
    depth_m = torch.clamp(_t(depth_m), min=1e-6)
    return camera.focal_px * camera.baseline_mm / depth_m / 1000.0


def _masked_mean(x: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return x.mean()
    valid = _t(valid).to(device=x.device, dtype=torch.float32)
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def end_point_error(pred_px, gt_px, valid: Optional[object] = None) -> torch.Tensor:
    """Mean absolute disparity error over ``valid`` pixels (all if None)."""
    pred = _t(pred_px)
    return _masked_mean((pred - _t(gt_px).to(pred.device)).abs(), valid)


def d1_all(pred_px, gt_px, valid: Optional[object] = None) -> torch.Tensor:
    """KITTI D1-all: the share of pixels off by more than 3 px and 5 % of GT."""
    pred = _t(pred_px)
    gt = _t(gt_px).to(pred.device)
    err = (pred - gt).abs()
    bad = ((err > 3.0) & (err > 0.05 * gt.abs())).float()
    return _masked_mean(bad, valid)

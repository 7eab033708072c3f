"""Disparity -> metric depth (counterpart of ``disparity_to_depth_m`` in
``hobot_stereonet_tpu/ops/disparity.py``)."""

from __future__ import annotations

import torch

from ..config import CameraConfig


def disparity_to_depth_m(disparity_px: torch.Tensor,
                         camera: CameraConfig = CameraConfig()) -> torch.Tensor:
    """Float disparity (px) -> depth (m): ``Z = f*B / max(d, 1e-6) / 1000``."""
    return camera.depth_from_disparity(disparity_px)

"""NV12 layout ops the ingest needs, on tensors.

Counterpart of the NV12 pieces of ``hobot_stereonet_tpu/ops/colorspace.py``:
the plane split and the nearest-neighbour YUV420 -> YUV444 upsample.  The
colour conversions wait for the RGB path.

NV12 layout: ``[H*W]`` Y plane, then ``[H/2 * W/2 * 2]`` interleaved UV.
"""

from __future__ import annotations

from typing import Tuple

import torch


def nv12_to_planes(nv12: torch.Tensor, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat NV12 [..., H*W*3/2] -> (Y [..., H, W], UV [..., H/2, W/2, 2])."""
    lead = nv12.shape[:-1]
    y = nv12[..., : height * width].reshape(*lead, height, width)
    uv = nv12[..., height * width:].reshape(*lead, height // 2, width // 2, 2)
    return y, uv


def yuv420_to_yuv444(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour chroma upsample: planes -> [..., H, W, 3] YUV444."""
    uv_full = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    return torch.cat([y[..., None], uv_full], dim=-1)

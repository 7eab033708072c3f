"""Colour-space and NV12 layout ops, on tensors.

Counterpart of ``hobot_stereonet_tpu/ops/colorspace.py``: the same BT.601
full-range constants and the same float32 arithmetic, on tensors of any
device.  Image ops take ``[..., H, W, C]``.

NV12 layout: ``[H*W]`` Y plane, then ``[H/2 * W/2 * 2]`` interleaved UV.
"""

from __future__ import annotations

from typing import Tuple

import torch

# BT.601 full-range (OpenCV's COLOR_BGR2YUV family), as the reference.
_KR, _KG, _KB = 0.299, 0.587, 0.114
_U_SCALE = 0.492
_V_SCALE = 0.877


def nv12_to_planes(nv12: torch.Tensor, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat NV12 [..., H*W*3/2] -> (Y [..., H, W], UV [..., H/2, W/2, 2])."""
    lead = nv12.shape[:-1]
    y = nv12[..., : height * width].reshape(*lead, height, width)
    uv = nv12[..., height * width:].reshape(*lead, height // 2, width // 2, 2)
    return y, uv


def planes_to_nv12(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(Y [H, W], UV [H/2, W/2, 2]) -> flat NV12 buffer in Y's dtype."""
    return torch.cat([y.reshape(-1), uv.reshape(-1).to(y.dtype)])


def yuv420_to_yuv444(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour chroma upsample: planes -> [..., H, W, 3] YUV444."""
    uv_full = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    return torch.cat([y[..., None], uv_full], dim=-1)


def yuv444_to_yuv420(yuv444: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chroma decimation: [..., H, W, 3] YUV444 -> (Y, UV), keeping the
    top-left chroma sample of each 2x2 quad."""
    return yuv444[..., 0], yuv444[..., ::2, ::2, 1:]


def bgr_to_yuv(bgr: torch.Tensor) -> torch.Tensor:
    """[..., 3] BGR (uint8 or float) -> YUV444 float32, BT.601 full range."""
    bgr = bgr.float()
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    y = _KR * r + _KG * g + _KB * b
    u = (b - y) * _U_SCALE + 128.0
    v = (r - y) * _V_SCALE + 128.0
    return torch.stack([y, u, v], dim=-1)


def yuv_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """[..., 3] YUV444 -> BGR float32, the inverse of :func:`bgr_to_yuv`."""
    yuv = yuv.float()
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    b = y + (u - 128.0) / _U_SCALE
    r = y + (v - 128.0) / _V_SCALE
    g = (y - _KR * r - _KB * b) / _KG
    return torch.stack([b, g, r], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """[..., 3] YUV444 -> RGB float32."""
    return yuv_to_bgr(yuv).flip(-1)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB (uint8 or float) -> YUV444 float32, the inverse of
    :func:`yuv_to_rgb`."""
    return bgr_to_yuv(rgb.flip(-1))


def bgr_to_nv12(bgr: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] BGR uint8 -> flat NV12 uint8: BT.601, chroma averaged over
    each 2x2 quad, rounded half to even and clipped to [0, 255]."""
    yuv = bgr_to_yuv(bgr)
    y = yuv[..., 0]
    h, w = y.shape
    uvs = yuv[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(dim=(1, 3))
    y8 = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    uv8 = torch.clamp(torch.round(uvs), 0, 255).to(torch.uint8)
    return planes_to_nv12(y8, uv8)


def split_side_by_side_nv12(nv12: torch.Tensor, height: int, full_width: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One side-by-side NV12 frame -> (left, right) flat NV12 buffers."""
    half = full_width // 2
    y, uv = nv12_to_planes(nv12, height, full_width)
    left = planes_to_nv12(y[:, :half], uv[:, : half // 2, :])
    right = planes_to_nv12(y[:, half:], uv[:, half // 2:, :])
    return left, right

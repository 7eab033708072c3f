"""NV12 ingest kernel: side-by-side NV12 bytes -> normalized YUV444.

Counterpart of ``hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py``
(``nv12_sbs_preprocess_pallas``).  The CUDA source is
``csrc/nv12_ingest.cu``; :func:`nv12_sbs_preprocess_plain` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import colorspace as cs
from . import build

NAME = "nv12_ingest"


def _check(sbs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    if sbs.dtype != torch.uint8:
        raise TypeError(f"{NAME}: expected uint8 frames, got {sbs.dtype}")
    if height % 2 or width % 2:
        raise ValueError(f"{NAME}: height and width must be even, got {height}x{width}")
    if sbs.dim() == 1:
        sbs = sbs[None]
    if sbs.dim() != 2 or sbs.shape[1] != 3 * height * width:
        raise ValueError(
            f"{NAME}: expected [B, {3 * height * width}] side-by-side NV12 "
            f"frames for {height}x{width} eyes, got {tuple(sbs.shape)}")
    return sbs


def nv12_sbs_preprocess_plain(sbs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, 3*H*W] (or [3*H*W]) uint8 -> [B, H, W, 6] bfloat16, plain PyTorch.

    ``width`` is one eye's width; each frame is Y [H, 2W] then interleaved
    UV [H/2, 2W].  Output channels are (k - 128)/128 of
    [Yl, Ul, Vl, Yr, Ur, Vr], chroma upsampled 2x by nearest neighbour.
    """
    sbs = _check(sbs, height, width)
    b, h, w = sbs.shape[0], height, width
    y, uv = cs.nv12_to_planes(sbs, h, 2 * w)                     # both eyes side by side
    y = y.reshape(b, h, 2, w).transpose(1, 2)                    # [b, eye, h, w]
    uv = uv.reshape(b, h // 2, 2, w // 2, 2).transpose(1, 2)     # [b, eye, h/2, w/2, 2]
    yuv = cs.yuv420_to_yuv444(y, uv)                             # [b, eye, h, w, 3]
    yuv = yuv.permute(0, 2, 3, 1, 4).reshape(b, h, w, 6)
    return ((yuv.float() - 128.0) * (1.0 / 128.0)).to(torch.bfloat16)


def nv12_sbs_preprocess(sbs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, 3*H*W] uint8 -> [B, H, W, 6] bfloat16 normalized YUV444.

    CUDA tensors go through the kernel in ``csrc/nv12_ingest.cu``; CPU
    tensors through :func:`nv12_sbs_preprocess_plain`.
    """
    if sbs.device.type == "cpu":
        return nv12_sbs_preprocess_plain(sbs, height, width)
    if sbs.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {sbs.device}")
    sbs = _check(sbs, height, width)
    if not sbs.is_contiguous():
        raise ValueError(f"{NAME}: frames must be contiguous")
    b = sbs.shape[0]
    out = torch.empty((b, height, width, 6), dtype=torch.bfloat16, device=sbs.device)
    err = build.library().hst_nv12_ingest(
        sbs.data_ptr(), out.data_ptr(), b, height, width, build.stream_handle(sbs))
    build.check(NAME, err)
    build.launch_counts[NAME] += 1
    return out

"""Camera ingest: side-by-side NV12 frames -> normalized model input.

Counterpart of ``hobot_stereonet_tpu/ops/preprocess.py``.  The NV12 ingest
serves the flagship's contract only: ``color_space="yuv"``, mean = std =
128, no int8 quantization.  The dataset path (:func:`rgb_pair_to_model_input`)
takes either colour space.  The NV12 -> RGB ingest and int8 wait for later
work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import PreprocessConfig, resolve_device
from . import colorspace as cs
from .kernels.preprocess_kernel import nv12_sbs_preprocess, nv12_sbs_preprocess_plain


def _check_contract(cfg: PreprocessConfig) -> None:
    if cfg.color_space != "yuv" or cfg.quantize:
        raise NotImplementedError(
            "the port ingests color_space='yuv' without int8 quantization only; "
            f"got color_space={cfg.color_space!r}, quantize={cfg.quantize}")
    if cfg.mean != 128.0 or cfg.std != 128.0:
        raise NotImplementedError(
            f"the ingest normalizes with mean = std = 128, got {cfg.mean}, {cfg.std}")


def normalize(x: torch.Tensor, cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """``(x - mean) / std`` in float32."""
    return (x.float() - cfg.mean) / cfg.std


def rgb_pair_to_model_input(
    left_rgb,
    right_rgb,
    cfg: PreprocessConfig = PreprocessConfig(),
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Dataset path: an [H, W, 3] uint8 RGB pair -> [1, H, W, 6] float32.

    With ``cfg.color_space == "yuv"`` each eye converts to YUV444 (clipped
    to [0, 255]) before it is normalized, as in the reference.  Numpy
    inputs are placed on ``device`` (default ``cuda:0``; pass
    ``device="cpu"`` on a machine without a card); tensors stay where they
    are.
    """
    if cfg.quantize:
        raise NotImplementedError("int8 input quantization is not ported yet")
    left, right = (t if isinstance(t, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(t)).to(
                       resolve_device(device, "rgb_pair_to_model_input"))
                   for t in (left_rgb, right_rgb))
    if cfg.color_space == "yuv":
        left = torch.clamp(cs.rgb_to_yuv(left), 0.0, 255.0)
        right = torch.clamp(cs.rgb_to_yuv(right), 0.0, 255.0)
    return normalize(torch.cat([left.float(), right.float()], dim=-1), cfg)[None]


def side_by_side_nv12_to_model_input(
    sbs_nv12: torch.Tensor,
    height: int,
    full_width: int,
    cfg: PreprocessConfig = PreprocessConfig(color_space="yuv"),
) -> torch.Tensor:
    """Side-by-side NV12 [L] or [B, L] uint8 -> [B, H, W, 6] float32.

    The reference's plain function of the same name
    (``hobot_stereonet_tpu/ops/preprocess.py:76-89``).  It is the ingest
    kernel's plain version in float32, which is exact: bf16 holds every
    normalized value.
    """
    _check_contract(cfg)
    return nv12_sbs_preprocess_plain(sbs_nv12, height, full_width // 2).float()


def nv12_ingest(
    sbs_nv12: torch.Tensor,
    height: int,
    full_width: int,
    cfg: PreprocessConfig = PreprocessConfig(color_space="yuv"),
) -> torch.Tensor:
    """Live-stream ingest: [B, L] uint8 frames -> [B, H, W, 6] bfloat16.

    Runs the NV12 ingest kernel (``ops/kernels/preprocess_kernel.py``) on
    the frames' device: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors.  bf16 holds every normalized value exactly.
    """
    _check_contract(cfg)
    return nv12_sbs_preprocess(sbs_nv12, height, full_width // 2)


def split_model_input(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,H,W,6] -> ([B,H,W,3] left, [B,H,W,3] right)."""
    return x[..., :3], x[..., 3:]

"""Camera ingest: side-by-side NV12 frames -> normalized model input.

Counterpart of ``hobot_stereonet_tpu/ops/preprocess.py``, with its whole
contract (``PreprocessConfig``): YUV444 or RGB input, any mean and std,
and the reference's int8 input quantization (``quantize``).  The live
ingest (:func:`nv12_ingest`) runs the NV12 ingest kernel
(``ops/kernels/preprocess_kernel.py``) when mean = std = 128 and the
quantization is the default one; other values take the plain functions
below, as the JAX package's ``use_pallas`` condition does.

Arithmetic is the JAX package's as XLA compiles it: a division by a
constant is a multiplication by its float32 reciprocal, and a multiply
followed by an add is one fused multiply-add (``ops/kernels/numerics.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import PreprocessConfig, resolve_device
from . import colorspace as cs
from .kernels.numerics import fma_f32, reciprocal_f32
from .kernels.preprocess_kernel import nv12_sbs_preprocess, yuv_bytes_to_rgb

# The input quantization the ingest kernel implements (preprocess.h:236-240).
_KERNEL_QUANT = dict(quant_scale=0.0078125, quant_zero_point=0.5, quant_min=-128, quant_max=127)


def normalize(x: torch.Tensor, cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """``(x - mean) / std`` in float32."""
    return (x.float() - cfg.mean) * reciprocal_f32(cfg.std)


def quantize_int8(x: torch.Tensor, cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """Floor-based int8 quantization of the reference (``preprocess.cpp:1131-1136``):
    ``clip(floor(x / scale + zero_point), min, max)``."""
    q = torch.floor(fma_f32(x.float(), reciprocal_f32(cfg.quant_scale), cfg.quant_zero_point))
    return torch.clamp(q, cfg.quant_min, cfg.quant_max).to(torch.int8)


def dequantize_int8(q: torch.Tensor, cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    return q.float() * cfg.quant_scale


def _to_device(arrays, device, who: str):
    return [t if isinstance(t, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(t)).to(resolve_device(device, who))
            for t in arrays]


def nv12_pair_to_model_input(
    left_nv12,
    right_nv12,
    height: int,
    width: int,
    cfg: PreprocessConfig = PreprocessConfig(),
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Two flat NV12 uint8 buffers -> [1, H, W, 6] float32 model input.

    Channels 0..2 are the left eye, 3..5 the right, YUV444 or, with
    ``cfg.color_space == "rgb"``, RGB clipped to [0, 255]; then normalized
    and, with ``cfg.quantize``, quantized to int8 and back.  Numpy inputs
    are placed on ``device`` (default ``cuda:0``).
    """
    eyes = []
    for nv12 in _to_device((left_nv12, right_nv12), device, "nv12_pair_to_model_input"):
        yuv = cs.yuv420_to_yuv444(*cs.nv12_to_planes(nv12, height, width)).float()
        eyes.append(yuv_bytes_to_rgb(yuv) if cfg.color_space == "rgb" else yuv)
    out = normalize(torch.cat(eyes, dim=-1), cfg)
    if cfg.quantize:
        out = dequantize_int8(quantize_int8(out, cfg), cfg)
    return out[None]


def side_by_side_nv12_to_model_input(
    sbs_nv12: torch.Tensor,
    height: int,
    full_width: int,
    cfg: PreprocessConfig = PreprocessConfig(),
) -> torch.Tensor:
    """Side-by-side NV12 frames [L] or [B, L] -> [B, H, W, 6] float32, in
    plain PyTorch: :func:`nv12_pair_to_model_input` of each frame's eyes."""
    frames = sbs_nv12 if sbs_nv12.dim() == 2 else sbs_nv12[None]
    return torch.cat([
        nv12_pair_to_model_input(*cs.split_side_by_side_nv12(f, height, full_width),
                                 height, full_width // 2, cfg)
        for f in frames])


def uses_ingest_kernel(cfg: PreprocessConfig) -> bool:
    """Whether :func:`nv12_ingest` runs the ingest kernel for ``cfg``."""
    return cfg.mean == 128.0 and cfg.std == 128.0 and (
        not cfg.quantize or all(getattr(cfg, k) == v for k, v in _KERNEL_QUANT.items()))


def nv12_ingest(
    sbs_nv12: torch.Tensor,
    height: int,
    full_width: int,
    cfg: PreprocessConfig = PreprocessConfig(),
) -> torch.Tensor:
    """Live-stream ingest: [B, L] uint8 frames -> [B, H, W, 6] model input.

    Through the ingest kernel (on the frames' device: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors) where
    :func:`uses_ingest_kernel`: bfloat16 for YUV, which holds every value
    exactly, float32 for RGB.  Otherwise frame by frame through
    :func:`side_by_side_nv12_to_model_input`, float32.
    """
    if uses_ingest_kernel(cfg):
        return nv12_sbs_preprocess(sbs_nv12, height, full_width // 2,
                                   rgb=cfg.color_space == "rgb", quantize=cfg.quantize)
    return side_by_side_nv12_to_model_input(sbs_nv12, height, full_width, cfg)


def rgb_pair_to_model_input(
    left_rgb,
    right_rgb,
    cfg: PreprocessConfig = PreprocessConfig(),
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Dataset path: an [H, W, 3] uint8 RGB pair -> [1, H, W, 6] float32.

    With ``cfg.color_space == "yuv"`` each eye converts to YUV444 (clipped
    to [0, 255]) before it is normalized, as in the reference.  Like the
    JAX package's, it does not quantize.  Numpy inputs are placed on
    ``device`` (default ``cuda:0``; pass ``device="cpu"`` on a machine
    without a card); tensors stay where they are.
    """
    left, right = _to_device((left_rgb, right_rgb), device, "rgb_pair_to_model_input")
    return rgb_batch_to_model_input(left, right, cfg)[None]


def rgb_batch_to_model_input(left: torch.Tensor, right: torch.Tensor,
                             cfg: PreprocessConfig = PreprocessConfig()) -> torch.Tensor:
    """[..., H, W, 3] uint8 RGB tensors -> [..., H, W, 6] float32: the
    arithmetic of :func:`rgb_pair_to_model_input` on any leading shape."""
    if cfg.color_space == "yuv":
        left = torch.clamp(cs.rgb_to_yuv(left), 0.0, 255.0)
        right = torch.clamp(cs.rgb_to_yuv(right), 0.0, 255.0)
    return normalize(torch.cat([left.float(), right.float()], dim=-1), cfg)


def split_model_input(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,H,W,6] -> ([B,H,W,3] left, [B,H,W,3] right)."""
    return x[..., :3], x[..., 3:]

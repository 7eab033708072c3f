"""NV12 ingest kernel: side-by-side NV12 bytes -> normalized model input.

Counterpart of ``hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py``
(``nv12_sbs_preprocess_pallas``) with the epilogues the JAX package's
``nv12_ingest`` puts after it: YUV -> RGB (``color_space="rgb"``) and the
input's int8 quantize-dequantize (``quantize=True``).  The CUDA source is
``csrc/nv12_ingest.cu``; :func:`nv12_sbs_preprocess_plain` is the same
function in plain PyTorch.

The RGB epilogue is ``hobot_stereonet_tpu/ops/colorspace.py``'s
``yuv_to_rgb`` as XLA compiles it (``numerics.py``): with y, u, v the bytes,

    b = fma(u - 128, 1/0.492, y),  r = fma(v - 128, 1/0.877, y),
    g = fma(-0.114, b, fma(-0.299, r, y)) * (1/0.587),

each reciprocal rounded to float32, then clipped to [0, 255] and
normalized, ``(x - 128) / 128``.  The quantize is ``floor(x * 128 + 0.5)``
clipped to [-128, 127], then ``* 1/128``.  Exhaustively checked against
XLA on the CPU over every (y, u, v) byte triple.
"""

from __future__ import annotations

import torch

from .. import colorspace as cs
from . import build
from .numerics import fma_f32, reciprocal_f32

NAME = "nv12_ingest"
_KR, _KB = 0.299, 0.114
_INV_U, _INV_V, _INV_KG = (reciprocal_f32(c) for c in (0.492, 0.877, 0.587))


def out_dtype(rgb: bool) -> torch.dtype:
    """float32 for RGB (not exact in bf16), bfloat16 for YUV (k/128 - 1 is)."""
    return torch.float32 if rgb else torch.bfloat16


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


def yuv_bytes_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 YUV bytes -> RGB clipped to [0, 255], as XLA computes it."""
    y, u, v = yuv.unbind(-1)
    b = fma_f32(u - 128.0, _INV_U, y)
    r = fma_f32(v - 128.0, _INV_V, y)
    g = fma_f32(-_KB, b, fma_f32(-_KR, r, y)) * _INV_KG
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def nv12_sbs_preprocess_plain(sbs: torch.Tensor, height: int, width: int,
                              rgb: bool = False, quantize: bool = False) -> torch.Tensor:
    """[B, 3*H*W] (or [3*H*W]) uint8 -> [B, H, W, 6], plain PyTorch.

    ``width`` is one eye's width; each frame is Y [H, 2W] then interleaved
    UV [H/2, 2W].  Chroma is upsampled 2x by nearest neighbour.  Output
    channels are (x - 128)/128 of [Yl, Ul, Vl, Yr, Ur, Vr] (bfloat16), or
    with ``rgb`` of [Rl, Gl, Bl, Rr, Gr, Br] (float32); ``quantize`` then
    rounds them to the input's int8 grid and back.
    """
    sbs = _check(sbs, height, width)
    b, h, w = sbs.shape[0], height, width
    y, uv = cs.nv12_to_planes(sbs, h, 2 * w)                     # both eyes side by side
    y = y.reshape(b, h, 2, w).transpose(1, 2)                    # [b, eye, h, w]
    uv = uv.reshape(b, h // 2, 2, w // 2, 2).transpose(1, 2)     # [b, eye, h/2, w/2, 2]
    yuv = cs.yuv420_to_yuv444(y, uv).float()                     # [b, eye, h, w, 3]
    x = yuv_bytes_to_rgb(yuv) if rgb else yuv
    out = (x.permute(0, 2, 3, 1, 4).reshape(b, h, w, 6) - 128.0) * (1.0 / 128.0)
    if quantize:
        out = torch.clamp(torch.floor(out * 128.0 + 0.5), -128.0, 127.0) * (1.0 / 128.0)
    return out.to(out_dtype(rgb))


def nv12_sbs_preprocess(sbs: torch.Tensor, height: int, width: int,
                        rgb: bool = False, quantize: bool = False) -> torch.Tensor:
    """[B, 3*H*W] uint8 -> [B, H, W, 6] normalized YUV444 (bfloat16) or RGB
    (float32, with ``rgb``), quantized to the input's int8 grid with
    ``quantize``.

    The custom op ``hst::nv12_sbs_preprocess``: CUDA tensors go through the
    kernel in ``csrc/nv12_ingest.cu``, CPU tensors through
    :func:`nv12_sbs_preprocess_plain`; other devices raise.
    """
    return torch.ops.hst.nv12_sbs_preprocess(_check(sbs, height, width), height, width,
                                             rgb, quantize)


@torch.library.custom_op("hst::nv12_sbs_preprocess", mutates_args=(), device_types="cpu")
def _preprocess_op(sbs: torch.Tensor, height: int, width: int, rgb: bool,
                   quantize: bool) -> torch.Tensor:
    return nv12_sbs_preprocess_plain(sbs, height, width, rgb, quantize)


@_preprocess_op.register_fake
def _(sbs, height, width, rgb, quantize):
    sbs = _check(sbs, height, width)
    return sbs.new_empty((sbs.shape[0], height, width, 6), dtype=out_dtype(rgb))


@_preprocess_op.register_kernel("cuda")
def _preprocess_cuda(sbs: torch.Tensor, height: int, width: int, rgb: bool,
                     quantize: bool) -> torch.Tensor:
    sbs = _check(sbs, height, width)
    if not sbs.is_contiguous():
        raise ValueError(f"{NAME}: frames must be contiguous")
    b = sbs.shape[0]
    out = torch.empty((b, height, width, 6), dtype=out_dtype(rgb), device=sbs.device)
    err = build.library().hst_nv12_ingest(
        sbs.data_ptr(), out.data_ptr(), b, height, width, int(rgb), int(quantize),
        build.stream_handle(sbs))
    build.check(NAME, err)
    build.launch_counts[NAME] += 1
    return out

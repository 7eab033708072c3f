"""Correlation-volume and fused soft-argmin kernels.

Counterparts of ``hobot_stereonet_tpu/ops/pallas/correlation.py``
(``correlation_volume_pallas`` and ``soft_argmin_pallas``).  The CUDA
sources are ``csrc/correlation.cu`` and ``csrc/soft_argmin.cu``; the
``*_plain`` functions are the same functions in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from . import build

CORRELATION = "correlation"
SOFT_ARGMIN = "soft_argmin"
_DTYPES = (torch.float32, torch.bfloat16)


def _check_features(feat_l: torch.Tensor, feat_r: torch.Tensor) -> None:
    if feat_l.shape != feat_r.shape or feat_l.dim() != 4:
        raise ValueError(
            f"{CORRELATION}: expected two [B,H,W,C] maps of one shape, got "
            f"{tuple(feat_l.shape)} and {tuple(feat_r.shape)}")
    if feat_l.dtype != feat_r.dtype or feat_l.dtype not in _DTYPES:
        raise TypeError(
            f"{CORRELATION}: expected float32 or bfloat16 features of one "
            f"type, got {feat_l.dtype} and {feat_r.dtype}")
    if feat_l.device != feat_r.device:
        raise ValueError(f"{CORRELATION}: features on {feat_l.device} and {feat_r.device}")


def correlation_volume_plain(feat_l: torch.Tensor, feat_r: torch.Tensor,
                             num_disparities: int) -> torch.Tensor:
    """[B,H,W,C] x2 -> [B,H,W,D] with ``out[..., x, d] = <fl[x], fr[x-d]> / sqrt(C)``,
    zero where ``x < d``.  Accumulates in f32, rounds once to the input type."""
    _check_features(feat_l, feat_r)
    w, c = feat_l.shape[2], feat_l.shape[3]
    fl, fr = feat_l.float(), feat_r.float()
    scale = 1.0 / math.sqrt(c)
    out = fl.new_zeros(fl.shape[:3] + (num_disparities,))
    for d in range(min(num_disparities, w)):
        out[:, :, d:, d] = (fl[:, :, d:] * fr[:, :, : w - d]).sum(-1) * scale
    return out.to(feat_l.dtype)


def correlation_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                       num_disparities: int) -> torch.Tensor:
    """Channel-last correlation volume [B,H,W,D] in the features' dtype.

    CUDA tensors go through ``csrc/correlation.cu``; CPU tensors through
    :func:`correlation_volume_plain`.
    """
    if feat_l.device.type == "cpu":
        return correlation_volume_plain(feat_l, feat_r, num_disparities)
    _check_features(feat_l, feat_r)
    if feat_l.device.type != "cuda":
        raise ValueError(f"{CORRELATION}: unsupported device {feat_l.device}")
    if not (feat_l.is_contiguous() and feat_r.is_contiguous()):
        raise ValueError(f"{CORRELATION}: features must be contiguous [B,H,W,C]")
    if num_disparities <= 0:
        raise ValueError(f"{CORRELATION}: num_disparities must be positive")
    b, h, w, c = feat_l.shape
    out = torch.empty((b, h, w, num_disparities), dtype=feat_l.dtype,
                      device=feat_l.device)
    err = build.library().hst_correlation(
        feat_l.data_ptr(), feat_r.data_ptr(), out.data_ptr(), b, h, w, c,
        num_disparities, int(feat_l.dtype == torch.bfloat16),
        build.stream_handle(feat_l))
    build.check(CORRELATION, err)
    build.launch_counts[CORRELATION] += 1
    return out


def _check_logits(logits: torch.Tensor) -> None:
    if logits.dim() != 4:
        raise ValueError(f"{SOFT_ARGMIN}: expected [B,H,W,D] logits, got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{SOFT_ARGMIN}: expected float32 or bfloat16, got {logits.dtype}")


def soft_argmin_confidence_plain(logits: torch.Tensor, scale: float = 1.0):
    """[B,H,W,D] logits -> (disp, conf), both [B,H,W] f32.

    With ``p = softmax(logits)`` over D (the softmax of ``cost = -logits``):
    ``disp = scale * sum_d d * p_d`` and ``conf = max_d p_d``.
    """
    _check_logits(logits)
    p = torch.softmax(logits.float(), dim=-1)
    d = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    return (p * d).sum(-1) * scale, p.amax(-1)


def soft_argmin_confidence(logits: torch.Tensor, scale: float = 1.0):
    """Fused soft-argmin disparity x ``scale`` and peak-probability confidence.

    CUDA tensors go through ``csrc/soft_argmin.cu``; CPU tensors through
    :func:`soft_argmin_confidence_plain`.
    """
    if logits.device.type == "cpu":
        return soft_argmin_confidence_plain(logits, scale)
    _check_logits(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"{SOFT_ARGMIN}: unsupported device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError(f"{SOFT_ARGMIN}: logits must be contiguous [B,H,W,D]")
    b, h, w, d = logits.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=logits.device)
    conf = torch.empty_like(disp)
    err = build.library().hst_soft_argmin(
        logits.data_ptr(), disp.data_ptr(), conf.data_ptr(), b * h * w, d,
        float(scale), int(logits.dtype == torch.bfloat16),
        build.stream_handle(logits))
    build.check(SOFT_ARGMIN, err)
    build.launch_counts[SOFT_ARGMIN] += 1
    return disp, conf

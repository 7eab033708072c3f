"""Correlation-volume and fused soft-argmin kernels.

Counterparts of ``hobot_stereonet_tpu/ops/pallas/correlation.py``
(``correlation_volume_pallas`` and ``soft_argmin_pallas``).  The CUDA
sources are ``csrc/correlation.cu`` and ``csrc/soft_argmin.cu``; the
``*_plain`` functions are the same functions in plain PyTorch.  The
soft-argmin comes in two layouts: channel-last logits [B,H,W,D] (the
flagship's, :func:`soft_argmin_confidence`) and a D-leading cost
[B,D,H,W] (the CLASSIC StereoNet's, :func:`soft_argmin_cost`).
"""

from __future__ import annotations

import math

import torch

from . import build

CORRELATION = "correlation"
SOFT_ARGMIN = "soft_argmin"
SOFT_ARGMIN_COST = "soft_argmin_cost"
SOFT_ARGMIN_VECTOR_D = 24     # D of the one-pass kernel (the flagship's coarse D)
_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_DTYPES = _DTYPES + (torch.float64,)    # the plain soft-argmin also takes float64


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


def correlation_divisor(c: int, dtype: torch.dtype) -> float:
    """``sqrt(C)`` as the reference divides by it: the float32 square root
    rounded to the features' dtype (5.65625 for C = 32 in bf16)."""
    return float(torch.tensor(math.sqrt(c), dtype=torch.float32).to(dtype))


def _correlation_plain(feat_l: torch.Tensor, feat_r: torch.Tensor, num_disparities: int,
                       round_gram) -> torch.Tensor:
    _check_features(feat_l, feat_r)
    w, c = feat_l.shape[2], feat_l.shape[3]
    dt = feat_l.dtype
    fl, fr = feat_l.float(), feat_r.float()
    divisor = correlation_divisor(c, dt)
    out = fl.new_zeros(fl.shape[:3] + (num_disparities,))
    for d in range(min(num_disparities, w)):
        gram = (fl[:, :, d:] * fr[:, :, : w - d]).sum(-1)
        out[:, :, d:, d] = round_gram(gram).float() / divisor
    return out.to(dt)


def correlation_volume_plain(feat_l: torch.Tensor, feat_r: torch.Tensor,
                             num_disparities: int) -> torch.Tensor:
    """[B,H,W,C] x2 -> [B,H,W,D] with ``out[..., x, d] = <fl[x], fr[x-d]> / sqrt(C)``,
    zero where ``x < d``.

    Rounds as ``build_correlation_volume`` in the JAX package does: the
    product sums in f32 and is rounded to the features' dtype, then divided
    by :func:`correlation_divisor` and rounded again.
    """
    return _correlation_plain(feat_l, feat_r, num_disparities,
                              lambda gram: gram.to(feat_l.dtype))


def correlation_gram_band(feat_l: torch.Tensor, feat_r: torch.Tensor,
                          num_disparities: int):
    """(lo, hi): bf16 volumes from :func:`correlation_volume_plain`'s
    arithmetic with each rounded Gram value moved one representable bf16
    step down and up.

    A kernel that sums the Gram value in another f32 order and then rounds
    as the reference does lands in ``[lo, hi]`` unless the sum is near zero
    (the division and the rounding after it are monotone).  One Gram step
    can become two steps of the output: the division by 5.65625 maps one
    step to 0.7 to 1.4 steps of the quotient.
    """
    if feat_l.dtype != torch.bfloat16:
        raise TypeError(f"{CORRELATION}: the Gram band is defined for bf16 features")
    return tuple(_correlation_plain(feat_l, feat_r, num_disparities,
                                    lambda gram, s=step: bf16_step(gram.bfloat16(), s))
                 for step in (-1, 1))


def _bf16_ordinal(t: torch.Tensor) -> torch.Tensor:
    """bf16 -> int32 that counts representable values (+0 and -0 are 0)."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Representable bf16 steps between two bf16 tensors, elementwise (int32;
    +0 and -0 count as one value).  The kernel checks measure with it."""
    return (_bf16_ordinal(a) - _bf16_ordinal(b)).abs()


def bf16_step(t: torch.Tensor, steps: int) -> torch.Tensor:
    """``t`` (bf16) moved ``steps`` representable values up (or down if < 0)."""
    o = _bf16_ordinal(t) + steps
    bits = torch.where(o < 0, (-o) | 0x8000, o)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16)


def correlation_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                       num_disparities: int) -> torch.Tensor:
    """Channel-last correlation volume [B,H,W,D] in the features' dtype.

    CUDA tensors go through ``csrc/correlation.cu``: bf16 on the tensor
    cores (C a multiple of 16 up to 256, 16-byte aligned maps), f32 in
    full f32.  CPU tensors go through :func:`correlation_volume_plain`.
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
    is_bf16 = feat_l.dtype == torch.bfloat16
    if is_bf16 and (c % 16 or c > 256):
        raise ValueError(f"{CORRELATION}: bf16 features need C % 16 == 0 and C <= 256 "
                         f"for the tensor-core kernel, got C = {c}")
    if is_bf16 and (feat_l.data_ptr() % 16 or feat_r.data_ptr() % 16):
        raise ValueError(f"{CORRELATION}: bf16 features must start 16-byte aligned")
    out = torch.empty((b, h, w, num_disparities), dtype=feat_l.dtype,
                      device=feat_l.device)
    err = build.library().hst_correlation(
        feat_l.data_ptr(), feat_r.data_ptr(), out.data_ptr(), b, h, w, c,
        num_disparities, correlation_divisor(c, feat_l.dtype), int(is_bf16),
        build.stream_handle(feat_l))
    build.check(CORRELATION, err)
    build.launch_counts[CORRELATION] += 1
    return out


def _check_logits(logits: torch.Tensor, dtypes=_DTYPES) -> None:
    if logits.dim() != 4:
        raise ValueError(f"{SOFT_ARGMIN}: expected [B,H,W,D] logits, got {tuple(logits.shape)}")
    if logits.dtype not in dtypes:
        raise TypeError(f"{SOFT_ARGMIN}: expected float32 or bfloat16, got {logits.dtype}")


def soft_argmin_confidence_plain(logits: torch.Tensor, scale: float = 1.0):
    """[B,H,W,D] logits -> (disp, conf), both [B,H,W] f32 (float64 for
    float64 logits, which only this plain version takes).

    With ``p = softmax(logits)`` over D (the softmax of ``cost = -logits``):
    ``disp = scale * sum_d d * p_d`` and ``conf = max_d p_d``.
    """
    _check_logits(logits, _PLAIN_DTYPES)
    dt = torch.promote_types(logits.dtype, torch.float32)
    p = torch.softmax(logits.to(dt), dim=-1)
    d = torch.arange(logits.shape[-1], dtype=dt, device=logits.device)
    return (p * d).sum(-1) * scale, p.amax(-1)


def uses_vector_kernel(logits: torch.Tensor) -> bool:
    """Whether CUDA logits take the one-pass 16-byte-load kernel (bf16,
    D = ``SOFT_ARGMIN_VECTOR_D``, 16-byte aligned rows); others take the
    generic kernel."""
    return (logits.dtype == torch.bfloat16 and logits.shape[-1] == SOFT_ARGMIN_VECTOR_D
            and logits.data_ptr() % 16 == 0)


def soft_argmin_confidence(logits: torch.Tensor, scale: float = 1.0):
    """Fused soft-argmin disparity x ``scale`` and peak-probability confidence.

    CUDA tensors go through ``csrc/soft_argmin.cu`` (its D = 24 bf16 kernel
    where :func:`uses_vector_kernel`, else its generic kernel); CPU tensors
    through :func:`soft_argmin_confidence_plain`.
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
        int(uses_vector_kernel(logits)), build.stream_handle(logits))
    build.check(SOFT_ARGMIN, err)
    build.launch_counts[SOFT_ARGMIN] += 1
    return disp, conf


def _check_cost(cost: torch.Tensor, dtypes=_DTYPES) -> None:
    if cost.dim() != 4:
        raise ValueError(f"{SOFT_ARGMIN_COST}: expected a [B,D,H,W] cost, got {tuple(cost.shape)}")
    if cost.dtype not in dtypes:
        raise TypeError(f"{SOFT_ARGMIN_COST}: expected float32 or bfloat16, got {cost.dtype}")


def soft_argmin_cost_plain(cost: torch.Tensor, scale: float = 1.0):
    """[B,D,H,W] cost -> (disp, conf), both [B,H,W] f32 (float64 for a
    float64 cost): the softmax of ``-cost`` over D,
    ``disp = scale * sum_d d * p_d``, ``conf = max_d p_d``."""
    _check_cost(cost, _PLAIN_DTYPES)
    return soft_argmin_confidence_plain(-cost.movedim(1, -1), scale)


def soft_argmin_cost(cost: torch.Tensor, scale: float = 1.0):
    """Fused soft-argmin disparity x ``scale`` and peak-probability
    confidence of a D-leading cost [B,D,H,W] (lower is better).

    CUDA tensors go through ``csrc/soft_argmin.cu``'s D-leading kernel,
    which reads the cost where it lies (it must be contiguous); CPU
    tensors through :func:`soft_argmin_cost_plain`.
    """
    if cost.device.type == "cpu":
        return soft_argmin_cost_plain(cost, scale)
    _check_cost(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"{SOFT_ARGMIN_COST}: unsupported device {cost.device}")
    if not cost.is_contiguous():
        raise ValueError(f"{SOFT_ARGMIN_COST}: the cost must be contiguous [B,D,H,W]")
    b, d, h, w = cost.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    conf = torch.empty_like(disp)
    err = build.library().hst_soft_argmin_dlead(
        cost.data_ptr(), disp.data_ptr(), conf.data_ptr(), b, d, h * w, float(scale),
        int(cost.dtype == torch.bfloat16), build.stream_handle(cost))
    build.check(SOFT_ARGMIN_COST, err)
    build.launch_counts[SOFT_ARGMIN_COST] += 1
    return disp, conf

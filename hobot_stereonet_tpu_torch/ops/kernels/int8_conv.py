"""w8a8 convolution: s8 x s8 -> s32 implicit GEMM with the dequant epilogue.

The JAX package computes each int8 conv as an XLA convolution with an int32
result (``hobot_stereonet_tpu/ops/quant.py``, ``_int8_conv`` and
``_int8_conv_static``); PyTorch has no such conv (``F.conv2d`` on int8
tensors returns int8 and wraps), so the port writes it by hand:
``csrc/int8_conv.cu``.  :func:`int8_conv_plain` is the same function in
plain PyTorch.

The function, for an input ``x`` [N, Cin, H, W] (float32 or bfloat16,
channels-last memory) and int8 weights ``q_w`` [Cout, Cin, kh, kw]:

    q   = clip(rint(x / qs[n]), -127, 127)      (divide; dynamic scales)
        = clip(rint(x * qs), -127, 127)         (static: qs = float32(1/s_x))
    acc = conv(q, q_w), flax "SAME" zero padding, int32
    y   = fma(float(acc), sx[n] * s_k[c], bias[c]), rounded once to out_dtype

``sx`` and ``qs`` hold one value per sample or one for all.  The static
scheme multiplies by the reciprocal and the epilogue fuses its multiply
and add, because that is what XLA compiles the JAX code into
(``numerics.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .numerics import fma_f32

NAME = "int8_conv"
QMAX = 127.0
_IN_DTYPES = (torch.float32, torch.bfloat16)


def same_pads(size: int, kernel: int, stride: int):
    """flax/XLA "SAME" padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def channels_per_tap(cin: int) -> int:
    """Channels of one tap in the packed weights: ``Cin`` rounded up to 32
    when ``Cin`` is a multiple of 8 (the kernel then loads 8 channels at a
    time), else ``Cin`` itself (taps packed densely, loaded one by one)."""
    return -(-cin // 32) * 32 if cin % 8 == 0 else cin


def pack_weight(q_w: torch.Tensor) -> torch.Tensor:
    """int8 [Cout, Cin, kh, kw] -> [Cout, K_pad]: the rows are
    [kh, kw, channels_per_tap(Cin)] flattened, zero padded to a multiple of 32."""
    cout, cin, kh, kw = q_w.shape
    cpt = channels_per_tap(cin)
    w = F.pad(q_w.permute(0, 2, 3, 1), (0, cpt - cin)).reshape(cout, kh * kw * cpt)
    k_pad = -(-w.shape[1] // 32) * 32
    return F.pad(w, (0, k_pad - w.shape[1])).contiguous()


def _check(x, q_w, s_k, bias, sx, qs, out_dtype) -> None:
    if x.dim() != 4 or q_w.dim() != 4 or x.shape[1] != q_w.shape[1]:
        raise ValueError(f"{NAME}: input {tuple(x.shape)} and weights {tuple(q_w.shape)} "
                         "do not match ([N, Cin, H, W] and [Cout, Cin, kh, kw])")
    if x.dtype not in _IN_DTYPES or out_dtype not in _IN_DTYPES:
        raise TypeError(f"{NAME}: float32 or bfloat16 only, got {x.dtype} -> {out_dtype}")
    if q_w.dtype != torch.int8:
        raise TypeError(f"{NAME}: int8 weights expected, got {q_w.dtype}")
    for name, t in (("s_k", s_k), ("bias", bias), ("sx", sx), ("qs", qs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
    if s_k.numel() != q_w.shape[0] or bias.numel() != q_w.shape[0]:
        raise ValueError(f"{NAME}: s_k and bias need {q_w.shape[0]} values")
    if sx.numel() != qs.numel() or sx.numel() not in (1, x.shape[0]):
        raise ValueError(f"{NAME}: sx and qs need 1 or {x.shape[0]} values, "
                         f"got {sx.numel()} and {qs.numel()}")


def int8_conv_plain(x: torch.Tensor, q_w: torch.Tensor, s_k: torch.Tensor,
                    bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, *,
                    stride: int, divide: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The function of the module docstring in plain PyTorch, channels-last out.

    The integer conv runs in float64, where every partial sum of int8
    products is exact (|acc| <= 127^2 * K < 2^53), and is then rounded to
    float32 as the kernel's int32 -> float32 conversion rounds it.
    """
    _check(x, q_w, s_k, bias, sx, qs, out_dtype)
    _, _, h, w = x.shape
    kh, kw = q_w.shape[2:]
    x32 = x.float()
    qv = qs.view(-1, 1, 1, 1)
    q = torch.clamp(torch.round(x32 / qv if divide else x32 * qv), -QMAX, QMAX)
    ph, pw = same_pads(h, kh, stride), same_pads(w, kw, stride)
    acc = F.conv2d(F.pad(q.double(), (pw[0], pw[1], ph[0], ph[1])), q_w.double(),
                   stride=stride).float()
    scale = sx.view(-1, 1, 1, 1) * s_k.view(1, -1, 1, 1)
    y = fma_f32(acc, scale, bias.view(1, -1, 1, 1))
    return y.to(out_dtype).contiguous(memory_format=torch.channels_last)


def int8_conv(x: torch.Tensor, q_w: torch.Tensor, packed: torch.Tensor, s_k: torch.Tensor,
              bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, *,
              stride: int, divide: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 conv: the kernel of ``csrc/int8_conv.cu`` for CUDA tensors,
    :func:`int8_conv_plain` for CPU tensors.  ``packed`` is
    :func:`pack_weight` of ``q_w``; ``x`` must be channels-last."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, q_w, s_k, bias, sx, qs, stride=stride, divide=divide,
                               out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    _check(x, q_w, s_k, bias, sx, qs, out_dtype)
    n, cin, h, w = x.shape
    cout, _, kh, kw = q_w.shape
    cpt = channels_per_tap(cin)
    if packed.dtype != torch.int8 or packed.shape != (cout, -(-kh * kw * cpt // 32) * 32):
        raise ValueError(f"{NAME}: packed weights {tuple(packed.shape)} {packed.dtype} "
                         f"are not pack_weight of {tuple(q_w.shape)}")
    if cout % 8:
        raise ValueError(f"{NAME}: Cout must be a multiple of 8, got {cout}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{NAME}: the input must be channels-last contiguous")
    if cin % 8 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{NAME}: the input must be 16-byte aligned")
    tensors = (x, packed, s_k, bias, sx, qs)
    if any(t.device != x.device for t in tensors) or not all(
            t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{NAME}: every tensor must be contiguous on {x.device}")
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x.device).permute(0, 3, 1, 2)
    err = build.library().hst_int8_conv(
        x.data_ptr(), packed.data_ptr(), s_k.data_ptr(), bias.data_ptr(), sx.data_ptr(),
        qs.data_ptr(), out.data_ptr(), n, h, w, cin, ho, wo, cout, kh, kw, stride,
        same_pads(h, kh, stride)[0], same_pads(w, kw, stride)[0], cpt, packed.shape[1],
        int(sx.numel() != 1), int(divide), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), build.stream_handle(x))
    build.check(NAME, err)
    build.launch_counts[NAME] += 1
    return out

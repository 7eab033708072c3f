"""The int8 convs the hand-written kernel does not take, as an exact library product.

The JAX package runs every int8 conv as an XLA convolution with an int32
result (``hobot_stereonet_tpu/ops/quant.py``, ``_int8_conv`` and
``_int8_conv_static``), none of them in a Pallas kernel.  On the card the
port runs every conv of both networks through its kernel
(``csrc/int8_conv.cu``, 2-D, dilated and 3-D taps).  A shape the kernel
does not take (:func:`~.kernels.int8_conv.kernel_takes`; neither network
has one) runs here, and ``chip_smoke.py`` times this route as the
yardstick of CLASSIC's 3-D and dilated convs:

  1. the input quantized as the kernel quantizes it
     (:func:`~.kernels.int8_conv.quantize_input`), to int8, channel-last;
  2. an explicit im2col with flax's "SAME" zero padding, any stride,
     dilation and number of spatial axes: [M, K] int8, M the output
     positions, K = taps x Cin in the weights' order, zero padded to what
     ``torch._int_mm`` takes;
  3. ``torch._int_mm`` (s8 x s8 -> s32 on the tensor cores) against the
     weights of :func:`gemm_weight` (Cout padded with zero rows): every
     product and sum exact in int32;
  4. the kernel's epilogue, one fused multiply-add in float32 as XLA
     compiles the JAX code, by the hand-written kernel of
     ``csrc/int8_epilogue.cu`` (:func:`~.kernels.int8_conv.int8_epilogue`),
     straight from the int32 product.

So each output equals :func:`~.kernels.int8_conv.int8_conv_plain` bit for
bit.  The route is chosen when the model is quantized, by shape
(``ops/quant.py``); ``calls["cuda"]`` counts its calls on the card.
"""

from __future__ import annotations

import collections
import itertools
import math

import torch
import torch.nn.functional as F

from .kernels.int8_conv import int8_epilogue, quantize_input, same_pads

# torch._int_mm takes M > 16 rows, and K and N multiples of 8; K and N are
# padded to at least 16 as well.
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE, INT_MM_MIN = 8, 16

calls: "collections.Counter[str]" = collections.Counter()


def _padded(v: int) -> int:
    return max(-(-v // INT_MM_MULTIPLE) * INT_MM_MULTIPLE, INT_MM_MIN)


def gemm_weight(q_w: torch.Tensor) -> torch.Tensor:
    """int8 [Cout, Cin, *kernel] -> [N_pad, K_pad] int8: row c holds output
    channel c's weights at k = tap * Cin + channel (taps in the kernel's
    row-major order), zero padded to K_pad; rows past Cout are zero."""
    cout = q_w.shape[0]
    w = q_w.permute(0, *range(2, q_w.dim()), 1).reshape(cout, -1)
    k = w.shape[1]
    return F.pad(w, (0, _padded(k) - k, 0, _padded(cout) - cout)).contiguous()


def int8_product(x: torch.Tensor, q_w: torch.Tensor, w_gemm: torch.Tensor, qs: torch.Tensor,
                 *, stride: int, dilation: int, divide: bool) -> tuple:
    """Steps 1-3 of the module docstring: (the int32 product [>= M, N_pad]
    of ``torch._int_mm``, M, the output's spatial shape).  ``x`` [N, Cin,
    *spatial] (float32 or bfloat16); ``w_gemm`` is :func:`gemm_weight` of
    ``q_w``; its rows m = (sample, output position) in row-major order."""
    n, cin = x.shape[:2]
    kernel = q_w.shape[2:]
    q = quantize_input(x.movedim(1, -1), qs, divide).to(torch.int8)   # [N, *spatial, Cin]
    pads = [same_pads(s, k, stride, dilation) for s, k in zip(x.shape[2:], kernel)]
    q = F.pad(q, [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi])
    out = [-(-s // stride) for s in x.shape[2:]]
    m, k_pad = n * math.prod(out), w_gemm.shape[1]
    cols = torch.empty((max(m, INT_MM_MIN_ROWS), k_pad), dtype=torch.int8, device=x.device)
    taps = math.prod(kernel)
    cols[:, taps * cin:].zero_()
    if m < cols.shape[0]:
        cols[m:].zero_()
    # Each tap's channels move as words as wide as Cin and the row allow.
    word = next(w for w in (8, 4, 2, 1) if cin % w == 0 and k_pad % w == 0)
    wide = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}[word]
    view = cols[:m].view(wide).view(n, *out, k_pad // word)
    q = q.view(wide)
    c = cin // word
    for t, offset in enumerate(itertools.product(*(range(k) for k in kernel))):
        window = tuple(slice(o * dilation, o * dilation + (s - 1) * stride + 1, stride)
                       for o, s in zip(offset, out))
        view[..., t * c:(t + 1) * c] = q[(slice(None),) + window]
    return torch._int_mm(cols, w_gemm.t()), m, out


def int8_conv_im2col(x: torch.Tensor, q_w: torch.Tensor, w_gemm: torch.Tensor,
                     s_k: torch.Tensor, bias: torch.Tensor, sx: torch.Tensor,
                     qs: torch.Tensor, *, stride: int, dilation: int, divide: bool,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 conv of :func:`~.kernels.int8_conv.int8_conv_plain`, on any
    device, through im2col and ``torch._int_mm``.  ``x`` [N, Cin, *spatial]
    (float32 or bfloat16); ``w_gemm`` is :func:`gemm_weight` of ``q_w``.
    Returns [N, Cout, *out] in ``out_dtype`` with channels-last memory."""
    n, cout = x.shape[0], q_w.shape[0]
    acc, m, out = int8_product(x, q_w, w_gemm, qs, stride=stride, dilation=dilation,
                               divide=divide)
    if x.device.type == "cuda":
        calls["cuda"] += 1
    y = int8_epilogue(acc, m, cout, m // n, sx, s_k, bias, out_dtype).view(n, *out, cout)
    return y.movedim(-1, 1)

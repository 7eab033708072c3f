"""Building blocks of the networks: ``ConvBlock``, ``ResBlock2D`` and ``ConvBlock3D``.

Counterparts of ``hobot_stereonet_tpu/models/layers.py``.  Modules run in
NCHW (PyTorch's layout); submodule names are the flax module names
(``Conv_0``, ``GroupNorm_0``, ``ConvBlock_0``) so that a flax parameter
path maps onto a ``state_dict`` key one to one (``runtime/weights.py``).

Where the reference's numerics differ from PyTorch's defaults:

  * padding "SAME" is flax's: for a 5x5 stride-2 conv on an even size it
    pads (1, 2), not (2, 2); a dilated kernel pads as one of extent
    (k - 1) * d + 1;
  * GroupNorm has eps 1e-6 and computes in float32 with float32 parameters,
    whatever the activation dtype, rounding its output to that dtype once;
  * LeakyReLU has slope 0.2 in the activation's dtype (bf16(0.2) =
    0.2001953125 in bfloat16, as flax multiplies), and ``ResBlock2D``
    applies it after the add;
  * a conv rounds its sum to the compute dtype and then adds the bias in
    that dtype, as flax's ``nn.Conv`` does: two roundings, not one.

A block hands its conv's sum without the bias (``add_bias=False``) to its
``GroupNorm_0`` with the bias, the skip and the activation
(``GroupNorm_0(y, conv_bias=..., skip=..., activate=True)``): one kernel
launch on the card for the bias add, the GroupNorm, the residual add and
the LeakyReLU, each rounding where the unfused ops round (on the CPU, those
very ops).

Under row tiling (``parallel/tiling.py``, a forward split by rows over the
ranks of a tile group) a conv runs its call on its tile extended by the
rows its taps reach and crops the output back to the tile, and a GroupNorm
splits at its statistics: ``group_norm_stats`` over the tile's rows, the
ranks' sums combined in rank order, then ``group_norm_apply`` with the
same fusions (``tiled_group_norm``, differentiable: the sharded train step).

Weights are float32 master weights, as flax's ``param_dtype=float32``: a
conv computes in its ``compute_dtype`` (set from the config by
:func:`set_compute_dtype`; None means its weight's dtype) and casts the
weight to it inside ``forward``, so bf16 training keeps float32 weights.
Serving casts the weights once (:func:`cast_convs`), which gives the same
bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.group_norm import group_norm_fused, leaky_relu, tiled_group_norm
from ..ops.kernels.int8_conv import same_pads
from ..parallel import tiling

GN_EPS = 1e-6


def num_groups(features: int) -> int:
    for g in (8, 4, 2, 1):
        if features % g == 0:
            return g
    return 1


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding, symmetric or not.  Like
    flax's ``nn.Conv`` it casts its input and its weight to the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, dilation=dilation)

    def forward(self, x: torch.Tensor, add_bias: bool = True) -> torch.Tensor:
        """The conv in the compute dtype; ``add_bias=False``: its sum before
        the bias add, which the caller then makes."""
        tiles = tiling.active()
        if tiles is not None:
            return tiles.conv(lambda t: self._conv(t, add_bias), x, 2, self.kernel_size[0],
                              self.stride[0], self.dilation[0])
        return self._conv(x, add_bias)

    def _conv(self, x: torch.Tensor, add_bias: bool) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        x, wt = x.to(dt), self.weight.to(dt)
        kh, kw = self.kernel_size
        ph = same_pads(x.shape[2], kh, self.stride[0], self.dilation[0])
        pw = same_pads(x.shape[3], kw, self.stride[1], self.dilation[1])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(x, wt, None, self.stride, (ph[0], pw[0]), self.dilation)
        else:
            y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), wt, None,
                         self.stride, 0, self.dilation)
        return y + self.bias.to(dt).view(1, -1, 1, 1) if add_bias else y


class SameConv3d(nn.Conv3d):
    """``nn.Conv3d`` over (D, H, W) with flax's "SAME" padding at stride 1
    (odd kernels: symmetric); casts its input and weight to the compute
    dtype, rounds the sum to it and then adds the bias in it, as
    :class:`SameConv2d`."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        if kernel % 2 != 1:
            raise ValueError(f"SameConv3d takes odd kernels, got {kernel}")
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor, add_bias: bool = True) -> torch.Tensor:
        tiles = tiling.active()
        if tiles is not None:                  # rows are dim 3 of [N, C, D, H, W]
            return tiles.conv(lambda t: self._conv(t, add_bias), x, 3, self.kernel_size[1],
                              1, 1)
        return self._conv(x, add_bias)

    def _conv(self, x: torch.Tensor, add_bias: bool) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.conv3d(x.to(dt), self.weight.to(dt), None, 1, self.padding)
        return y + self.bias.to(dt).view(1, -1, 1, 1, 1) if add_bias else y


def conv_without_bias(conv: nn.Module, x: torch.Tensor):
    """(the conv's output before its bias add, that bias): a ``SameConv2d``
    or ``SameConv3d`` leaves the add to the GroupNorm; any other conv (the
    int8 conv, whose epilogue adds the bias) returns its output and None.
    The conv runs through its ``__call__``, so that its hooks see it."""
    if isinstance(conv, (SameConv2d, SameConv3d)):
        return conv(x, add_bias=False), conv.bias
    return conv(x), None


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm``: eps 1e-6, float32 statistics and parameters,
    over (C/G, *spatial) of NCHW or NCDHW input.

    bf16 and float32 input go through
    :func:`~..ops.kernels.group_norm.group_norm_fused`: the CUDA kernel on
    the card, its plain version on the CPU.  Both compute
    ATen's one-thread statistics of a channels-last input, in one order
    whatever the thread count or the batch.  They are not the reference's
    to the last bit, and no formulation of them tried reproduces those
    (``tests/test_torch_reference.py``).  float64 input stays on
    ``F.group_norm``.
    """

    def __init__(self, channels: int):
        super().__init__(num_groups(channels), channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor, conv_bias: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None, activate: bool = False) -> torch.Tensor:
        """GroupNorm of ``x``; with ``conv_bias``, ``skip`` or ``activate``:
        ``leaky_relu([skip +] GroupNorm(x + conv_bias.to(x.dtype)))``."""
        tiles = tiling.active()
        if tiles is not None:
            return self._tiled(tiles, x, conv_bias, skip, activate)
        if x.dtype == torch.float64:
            a = x if conv_bias is None else x + conv_bias.to(x.dtype).view(
                (1, -1) + (1,) * (x.dim() - 2))
            r = F.group_norm(a, self.num_groups, self.weight.double(), self.bias.double(),
                             self.eps)
            r = r if skip is None else skip + r
            return leaky_relu(r) if activate else r
        return group_norm_fused(x, self.num_groups, self.weight.float(), self.bias.float(),
                                self.eps, conv_bias=conv_bias, skip=skip, activate=activate)

    def _tiled(self, tiles, x, conv_bias, skip, activate):
        """The GroupNorm of a row tile: the statistics of the whole image from
        every rank's sums, then this tile's output; differentiable (the
        backward sums its statistics' gradient terms over the tile group)."""
        dt = torch.float64 if x.dtype == torch.float64 else torch.float32
        return tiled_group_norm(x, self.num_groups, self.weight.to(dt), self.bias.to(dt),
                                self.eps, tiles, conv_bias=conv_bias, skip=skip,
                                activate=activate)


class ConvBlock(nn.Module):
    """Conv2D + GroupNorm + LeakyReLU(0.2)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, kernel, stride, dilation)
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = conv_without_bias(self.Conv_0, x)
        return self.GroupNorm_0(y, conv_bias=bias, activate=True)


class ResBlock2D(nn.Module):
    """Two 3x3 convs (dilated by ``dilation``) with a skip connection;
    LeakyReLU after the add."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(features, features, dilation=dilation)
        self.Conv_0 = SameConv2d(features, features, 3, dilation=dilation)
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = conv_without_bias(self.Conv_0, self.ConvBlock_0(x))
        return self.GroupNorm_0(y, conv_bias=bias, skip=x, activate=True)


class ConvBlock3D(nn.Module):
    """Conv3D (3x3x3 over D, H, W) + GroupNorm + LeakyReLU(0.2), NCDHW."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = SameConv3d(in_ch, features, kernel)
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = conv_without_bias(self.Conv_0, x)
        return self.GroupNorm_0(y, conv_bias=bias, activate=True)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every conv of ``module`` computes in ``dtype`` whatever its weights'
    dtype (flax's ``dtype`` beside ``param_dtype``)."""
    for m in module.modules():
        if isinstance(m, (SameConv2d, SameConv3d)):
            m.compute_dtype = dtype
    return module


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Put every conv's weights in ``dtype`` (the compute dtype) and leave
    GroupNorm's in float32, as the reference computes them."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            m.to(dtype)
    return module

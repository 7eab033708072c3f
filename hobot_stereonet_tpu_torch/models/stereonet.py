"""Feature tower of the stereo networks.

Counterpart of ``FeatureTower`` in ``hobot_stereonet_tpu/models/stereonet.py``
(the CLASSIC StereoNet itself waits for later work).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import StereoNetConfig
from .layers import ConvBlock, ResBlock2D, SameConv2d


class FeatureTower(nn.Module):
    """Shared-weight extractor: [N, 3, H, W] -> [N, C, H/2^K, W/2^K] (NCHW).

    K stride-2 5x5 ``ConvBlock``s, ``num_feature_res_blocks`` ``ResBlock2D``s
    and a 3x3 projection without activation.
    """

    def __init__(self, cfg: StereoNetConfig):
        super().__init__()
        c = cfg.feature_channels
        in_ch = cfg.input_channels
        for i in range(cfg.downsample_factor):
            setattr(self, f"ConvBlock_{i}", ConvBlock(in_ch, c, kernel=5, stride=2))
            in_ch = c
        for i in range(cfg.num_feature_res_blocks):
            setattr(self, f"ResBlock2D_{i}", ResBlock2D(c))
        self.Conv_0 = SameConv2d(c, c, 3)
        self._down = cfg.downsample_factor
        self._res = cfg.num_feature_res_blocks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self._down):
            x = getattr(self, f"ConvBlock_{i}")(x)
        for i in range(self._res):
            x = getattr(self, f"ResBlock2D_{i}")(x)
        return self.Conv_0(x)

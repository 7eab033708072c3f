"""FastStereoNet, the flagship network.

Counterpart of ``hobot_stereonet_tpu/models/fast_stereonet.py``.  The
public interface keeps the reference's layouts: channel-last inputs
[B,H,W,3], disparity [B,H,W] and confidence [B,H/8,W/8] in float32.
Inside, convolutions run in NCHW with channels-last memory, so the
channel-last views the kernels take cost no copy.

The path: one ``FeatureTower`` call on both eyes (batch 2B), the
correlation volume (CUDA kernel), ``CorrelationAggregation2D``, the fused
soft-argmin and confidence (CUDA kernel), then either the mask head and
``convex_upsample`` x8 (``upsample_mode="convex"``, the flagship) or the
CLASSIC StereoNet's hierarchical refinement (``"refine"``).

A network whose ``compute_dtype`` is float32 runs its forward on CUDA with
TF32 off (``utils/precision.py``), as the reference's float32 computes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..config import StereoNetConfig, resolve_device
from ..ops.cost_volume import build_correlation_volume
from ..ops.soft_argmin import soft_argmin_confidence
from ..ops.upsample import convex_upsample
from ..utils.precision import exact_float32
from .layers import ConvBlock, ResBlock2D, SameConv2d, set_compute_dtype
from .stereonet import (FeatureTower, _nchw, _nhwc, add_refinement_nets, channels_last, refine,
                        tower_features)


class CorrelationAggregation2D(nn.Module):
    """2D-conv aggregation of cat([corr (D), feat_l (C)]) -> (logits, features)."""

    def __init__(self, cfg: StereoNetConfig):
        super().__init__()
        d = cfg.num_disparities_coarse
        c = max(cfg.aggregation_channels, 64)
        self.ConvBlock_0 = ConvBlock(d + cfg.feature_channels, c)
        for i in range(cfg.num_aggregation_layers):
            setattr(self, f"ResBlock2D_{i}", ResBlock2D(c))
        self.Conv_0 = SameConv2d(c, d, 3)
        self._layers = cfg.num_aggregation_layers

    def forward(self, corr: torch.Tensor, feat_l: torch.Tensor):
        """corr [B,h,w,D], feat_l [B,h,w,C] -> (logits, features), both NCHW."""
        x = _nchw(torch.cat([corr, feat_l.to(corr.dtype)], dim=-1))
        x = self.ConvBlock_0(x)
        for i in range(self._layers):
            x = getattr(self, f"ResBlock2D_{i}")(x)
        return self.Conv_0(x), x


class FastStereoNet(nn.Module):
    """The flagship network, built on ``device`` (default ``cuda:0``; pass
    ``device="cpu"`` for the plain versions of the kernels) with
    channels-last weights."""

    def __init__(self, cfg: StereoNetConfig = StereoNetConfig(),
                 device: "str | torch.device | None" = None):
        super().__init__()
        if cfg.upsample_mode not in ("convex", "refine"):
            raise ValueError(f"unknown upsample_mode {cfg.upsample_mode!r}")
        self.cfg = cfg
        k = cfg.cost_resolution_divisor
        with resolve_device(device, "FastStereoNet"):
            self.FeatureTower_0 = FeatureTower(cfg)
            self.CorrelationAggregation2D_0 = CorrelationAggregation2D(cfg)
            if cfg.upsample_mode == "convex":
                agg = max(cfg.aggregation_channels, 64)
                self.upsample_mask_hidden = ConvBlock(agg, 64)
                self.upsample_mask = SameConv2d(64, 9 * k * k, 3)
            else:
                add_refinement_nets(self, cfg)
        channels_last(self)
        set_compute_dtype(self, cfg.compute_dtype)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, Any]:
        """left, right [B,H,W,3] -> {"disparity" [B,H,W], "confidence"
        [B,H/k,W/k], "pyramid" [coarse x k, then the full-resolution one or
        each refinement stage]}, all float32."""
        with exact_float32(self.cfg.compute_dtype, left.device):
            return self._forward(left, right)

    def _forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, Any]:
        cfg = self.cfg
        b = left.shape[0]
        k = cfg.cost_resolution_divisor
        # The first conv casts the input to the compute dtype; its int8
        # counterpart (ops/quant.py) quantizes the input as it comes.
        feats = tower_features(self, left, right)
        feat_l, feat_r = feats[:b], feats[b:]

        # [B, D, h, w] view -> channel-last [B, h, w, D]
        corr = build_correlation_volume(feat_l, feat_r, cfg.num_disparities_coarse)
        logits, agg_feats = self.CorrelationAggregation2D_0(corr.permute(0, 2, 3, 1), feat_l)

        # cost = -logits; disparity scaled to full-res px inside the kernel.
        disp_coarse, conf = soft_argmin_confidence(_nhwc(logits), scale=float(k))
        pyramid = [disp_coarse]
        if cfg.upsample_mode == "convex":
            mask = self.upsample_mask(self.upsample_mask_hidden(agg_feats))
            disp = convex_upsample(disp_coarse, _nhwc(mask), k)
            pyramid.append(disp)
        else:
            disp = refine(self, cfg, disp_coarse, left, pyramid)
        return {"disparity": disp, "pyramid": pyramid, "confidence": conf}

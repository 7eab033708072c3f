"""The CLASSIC StereoNet (Khamis et al., ECCV 2018) and its parts.

Counterpart of ``hobot_stereonet_tpu/models/stereonet.py``:

  1. a shared ``FeatureTower`` over both eyes (one call, batch 2B);
  2. the difference cost volume over D = max_disparity / 2^K candidates,
     [B, D, h, w, C] in memory (``ops/cost_volume.py``);
  3. ``CostAggregation``: 3x3x3 ``ConvBlock3D``s in NCDHW with
     ``channels_last_3d`` memory (a view of the volume, no copy), then a
     3x3x3 conv to one channel, which leaves the cost [B, D, h, w]
     contiguous;
  4. the fused soft-argmin and confidence kernel over that D-leading cost
     (``ops/kernels/correlation.py::soft_argmin_cost``), the disparity
     scaled by 2^K to full-resolution pixels inside it;
  5. hierarchical refinement back to full resolution: 2x bilinear
     upsampling and a ``RefinementNet`` (dilated residual blocks guided by
     the left image, average-pooled to the scale) at each scale.

Inputs and outputs keep ``FastStereoNet``'s layouts: [B,H,W,3] in;
``disparity`` [B,H,W], ``confidence`` [B,h,w] and ``pyramid`` (coarse to
fine) out, all float32.  ``cfg.remat`` recomputes the feature tower in
the backward pass instead of keeping its activations (``torch.utils.checkpoint``,
as the reference's ``nn.remat(FeatureTower)``); it changes no result.

A network whose ``compute_dtype`` is float32 runs its forward on CUDA with
TF32 off (``utils/precision.py``), as the reference's float32 computes.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..config import StereoNetConfig, resolve_device
from ..ops.cost_volume import build_cost_volume
from ..ops.soft_argmin import soft_argmin_cost
from ..ops.upsample import downsample_avg, upsample2x_bilinear
from ..utils.precision import exact_float32
from .layers import ConvBlock, ConvBlock3D, ResBlock2D, SameConv2d, SameConv3d, set_compute_dtype

# Dilations of a RefinementNet's residual blocks, repeated past six blocks.
REFINE_DILATIONS = (1, 2, 4, 8, 1, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> NCHW view with channels-last memory (copies only if needed)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous [B,H,W,C] (a view for channels-last memory)."""
    return x.permute(0, 2, 3, 1).contiguous()


def channels_last(module: nn.Module) -> nn.Module:
    """Every 2-D conv's weight in ``channels_last`` memory and every 3-D
    conv's in ``channels_last_3d``, so that cuDNN keeps activations
    channel-last."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fmt = torch.channels_last_3d if isinstance(m, nn.Conv3d) else torch.channels_last
            m.weight.data = m.weight.data.contiguous(memory_format=fmt)
    return module


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
        self._dtype = cfg.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self._dtype)        # as flax's tower: an int8 conv quantizes the cast input
        for i in range(self._down):
            x = getattr(self, f"ConvBlock_{i}")(x)
        for i in range(self._res):
            x = getattr(self, f"ResBlock2D_{i}")(x)
        return self.Conv_0(x)


def tower_features(module: nn.Module, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``module.FeatureTower_0`` on both eyes at once (batch 2B) -> [2B,h,w,C];
    rematerialized in the backward pass when ``module.cfg.remat``."""
    x = _nchw(torch.cat([left, right], 0))
    tower = module.FeatureTower_0
    if module.cfg.remat and torch.is_grad_enabled():
        return _nhwc(checkpoint(tower, x, use_reentrant=False))
    return _nhwc(tower(x))


class CostAggregation(nn.Module):
    """3-D conv aggregation: a [B, D, H, W, C] volume -> [B, D, H, W] cost."""

    def __init__(self, cfg: StereoNetConfig, in_ch: int = 0):
        super().__init__()
        c = cfg.aggregation_channels
        in_ch = in_ch or cfg.feature_channels
        for i in range(cfg.num_aggregation_layers):
            setattr(self, f"ConvBlock3D_{i}", ConvBlock3D(in_ch, c))
            in_ch = c
        self.Conv_0 = SameConv3d(in_ch, 1, 3)
        self._layers = cfg.num_aggregation_layers

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        x = volume.permute(0, 4, 1, 2, 3)          # NCDHW, channels_last_3d memory
        for i in range(self._layers):
            x = getattr(self, f"ConvBlock3D_{i}")(x)
        return self.Conv_0(x)[:, 0]


class RefinementNet(nn.Module):
    """Edge-aware residual refinement at one scale: disparity [B,H,W] (f32,
    full-resolution px) and guide image [B,H,W,3] -> refined disparity
    [B,H,W] f32, ``relu(disparity + delta)``.  A ``ConvBlock`` on
    ``[disparity, guide]``, ``blocks`` dilated ``ResBlock2D``s
    (:data:`REFINE_DILATIONS`) and a 3x3 conv to the residual."""

    def __init__(self, cfg: StereoNetConfig, channels: int = 0, blocks: int = 0):
        super().__init__()
        c = channels or cfg.refinement_channels
        nb = blocks or cfg.num_refinement_res_blocks
        self.ConvBlock_0 = ConvBlock(1 + cfg.input_channels, c)
        for i in range(nb):
            setattr(self, f"ResBlock2D_{i}",
                    ResBlock2D(c, dilation=REFINE_DILATIONS[i % len(REFINE_DILATIONS)]))
        self.Conv_0 = SameConv2d(c, 1, 3)
        self._blocks = nb
        self._dtype = cfg.compute_dtype

    def forward(self, disparity: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        # [disparity, guide] in the compute dtype, as flax's (an int8 conv
        # quantizes the cast values).
        x = self.ConvBlock_0(_nchw(torch.cat([disparity[..., None], guide.float()], -1)
                                   .to(self._dtype)))
        for i in range(self._blocks):
            x = getattr(self, f"ResBlock2D_{i}")(x)
        return torch.relu(disparity + self.Conv_0(x)[:, 0].float())


def _refine_size(cfg: StereoNetConfig, stage: int):
    """(channels, blocks) of refinement stage ``stage`` (coarse -> fine)."""
    rc, rb = cfg.refinement_channels, cfg.num_refinement_res_blocks
    if cfg.refinement_scale_channels:
        rc = cfg.refinement_scale_channels[min(stage, len(cfg.refinement_scale_channels) - 1)]
    if cfg.refinement_scale_blocks:
        rb = cfg.refinement_scale_blocks[min(stage, len(cfg.refinement_scale_blocks) - 1)]
    return rc, rb


def refinement_scales(cfg: StereoNetConfig) -> List[int]:
    """The downsampling factor of each refinement stage, coarse to fine."""
    if not cfg.hierarchical_refinement:
        return [1]
    return [2 ** i for i in range(cfg.downsample_factor - 1, -1, -1)]


def add_refinement_nets(module: nn.Module, cfg: StereoNetConfig) -> None:
    """``RefinementNet_0..`` on ``module``, one per refinement stage."""
    for i in range(len(refinement_scales(cfg))):
        rc, rb = _refine_size(cfg, i)
        setattr(module, f"RefinementNet_{i}", RefinementNet(cfg, channels=rc, blocks=rb))


def refine(module: nn.Module, cfg: StereoNetConfig, disp: torch.Tensor, left: torch.Tensor,
           pyramid: List[torch.Tensor]) -> torch.Tensor:
    """Hierarchical refinement of a coarse disparity [B,h,w] (full-res px)
    with ``module``'s ``RefinementNet_i``: upsample 2x until the stage's
    size, refine against the left image pooled to it; each stage's output
    is appended to ``pyramid``.  Returns the finest disparity."""
    h = left.shape[1]
    for i, s in enumerate(refinement_scales(cfg)):
        while disp.shape[1] < h // s:
            disp = upsample2x_bilinear(disp[..., None])[..., 0]
        guide = left if s == 1 else downsample_avg(left, s)
        disp = getattr(module, f"RefinementNet_{i}")(disp, guide)
        pyramid.append(disp)
    return disp


class StereoNet(nn.Module):
    """The CLASSIC StereoNet, built on ``device`` (default ``cuda:0``; pass
    ``device="cpu"`` for the plain versions of the kernels) with
    channel-last weights."""

    def __init__(self, cfg: StereoNetConfig = StereoNetConfig(),
                 device: "str | torch.device | None" = None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device, "StereoNet"):
            self.FeatureTower_0 = FeatureTower(cfg)
            self.CostAggregation_0 = CostAggregation(cfg)
            add_refinement_nets(self, cfg)
        channels_last(self)
        set_compute_dtype(self, cfg.compute_dtype)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, Any]:
        """left, right [B,H,W,3] -> {"disparity" [B,H,W], "confidence"
        [B,H/k,W/k], "pyramid" [coarse x k, then each refinement stage]},
        all float32."""
        with exact_float32(self.cfg.compute_dtype, left.device):
            return self._forward(left, right)

    def _forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, Any]:
        cfg = self.cfg
        b = left.shape[0]
        feats = tower_features(self, left, right)
        volume = build_cost_volume(feats[:b], feats[b:], cfg.num_disparities_coarse)
        cost = self.CostAggregation_0(volume)               # [B, D, h, w]
        disp, conf = soft_argmin_cost(cost, scale=float(cfg.cost_resolution_divisor))
        pyramid = [disp]
        disp = refine(self, cfg, disp, left, pyramid)
        return {"disparity": disp, "pyramid": pyramid, "confidence": conf}

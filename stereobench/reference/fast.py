"""Plain float32 reference of FastStereoNet, the flagship network.

The path: a shared feature tower over both eyes; the dot-product correlation
of the left features with the right ones shifted by each of D = max_disparity
/ 2^K candidates, divided by sqrt(C), zero where the shift leaves the image;
a 2-D aggregation of [correlation, left features] to D logits; softmax over D,
disparity as the expected candidate scaled by 2^K, confidence as the peak
probability; a mask head and a learned convex upsampling by 2^K, each fine
pixel a softmax-weighted mix of its coarse pixel's zero-padded 3x3
neighbourhood.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, conv2d, conv_block, feature_tower, res_block, soft_argmin


def correlation(fl: torch.Tensor, fr: torch.Tensor, d_max: int) -> torch.Tensor:
    """[B, C, h, w] x2 -> [B, D, h, w]: <fl[x], fr[x - d]> / sqrt(C), 0 where x < d."""
    b, c, h, w = fl.shape
    out = fl.new_zeros((b, d_max, h, w))
    for d in range(min(d_max, w)):
        out[:, d, :, d:] = (fl[..., d:] * fr[..., :w - d]).sum(1) / c ** 0.5
    return out


def convex_upsample(disp: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """disp [B, h, w], mask [B, 9 k^2, h, w] (channels as (9, k^2)) -> [B, hk, wk]."""
    b, h, w = disp.shape
    m = torch.softmax(mask.view(b, 9, k * k, h, w), dim=1)
    dp = F.pad(disp, (1, 1, 1, 1))
    nb = torch.stack([dp[:, i:i + h, j:j + w] for i in range(3) for j in range(3)], 1)
    fine = (nb[:, :, None] * m).sum(1)                       # [B, k*k, h, w]
    return fine.view(b, k, k, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * k, w * k)


def forward(p: Params, left: torch.Tensor, right: torch.Tensor, model: dict) -> dict:
    """left, right [B, 3, H, W] float32 -> {"disparity" [B, H, W], "confidence"
    [B, H/k, W/k]}."""
    k = 2 ** model["downsample_factor"]
    b = left.shape[0]
    f = feature_tower(torch.cat([left, right]), p, model["downsample_factor"],
                      model["num_feature_res_blocks"])
    fl, fr = f[:b], f[b:]
    x = torch.cat([correlation(fl, fr, model["max_disparity"] // k), fl], 1)
    agg = "CorrelationAggregation2D_0"
    x = conv_block(x, p, agg + "/ConvBlock_0")
    for i in range(model["num_aggregation_layers"]):
        x = res_block(x, p, f"{agg}/ResBlock2D_{i}")
    disp, conf = soft_argmin(conv2d(x, p, agg + "/Conv_0"), float(k))
    mask = conv2d(conv_block(x, p, "upsample_mask_hidden"), p, "upsample_mask")
    return {"disparity": convex_upsample(disp, mask, k), "confidence": conf}

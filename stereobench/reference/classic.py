"""Plain float32 reference of the CLASSIC StereoNet (Khamis et al., ECCV 2018,
arXiv:1807.08865), as the trained weights define it.

The path: a shared feature tower over both eyes; the difference cost volume
``left - right shifted by d`` (the shifted features zero where the shift
leaves the image) over D = max_disparity / 2^K candidates; 3x3x3 conv blocks
over (D, h, w) and a 3x3x3 conv to one channel, the cost; softmax of the
negated cost over D, disparity as the expected candidate scaled by 2^K,
confidence as the peak probability; hierarchical refinement from 1/2^(K-1)
to full resolution, each stage a 2x bilinear upsampling (half-pixel centres,
edges repeated) and a residual net of dilated blocks (1, 2, 4, 8, 1, 1)
guided by the left image averaged down to the stage's scale, ``relu(d +
residual)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import GN_EPS, Params, conv2d, conv3d, conv_block, feature_tower, leaky, \
    num_groups, res_block, soft_argmin

DILATIONS = (1, 2, 4, 8, 1, 1)


def cost_volume(fl: torch.Tensor, fr: torch.Tensor, d_max: int) -> torch.Tensor:
    """[B, C, h, w] x2 -> [B, C, D, h, w]: fl - fr shifted right by d."""
    w = fl.shape[-1]
    planes = []
    for d in range(d_max):
        shifted = torch.zeros_like(fr)
        if d < w:
            shifted[..., d:] = fr[..., :w - d]
        planes.append(fl - shifted)
    return torch.stack(planes, 2)


def _blocks(p: Params, prefix: str) -> int:
    n = 0
    while p.has(f"{prefix}/ResBlock2D_{n}"):
        n += 1
    return n


def forward(p: Params, left: torch.Tensor, right: torch.Tensor, model: dict) -> dict:
    """left, right [B, 3, H, W] float32 -> {"disparity" [B, H, W], "confidence"
    [B, H/k, W/k]}."""
    df = model["downsample_factor"]
    k = 2 ** df
    b, h_full = left.shape[0], left.shape[2]
    f = feature_tower(torch.cat([left, right]), p, df, model["num_feature_res_blocks"])
    x = cost_volume(f[:b], f[b:], model["max_disparity"] // k)
    for i in range(model["num_aggregation_layers"]):
        path = f"CostAggregation_0/ConvBlock3D_{i}"
        y = conv3d(x, p, path + "/Conv_0")
        x = leaky(F.group_norm(y, num_groups(y.shape[1]), p[path + "/GroupNorm_0/scale"],
                               p[path + "/GroupNorm_0/bias"], GN_EPS))
    cost = conv3d(x, p, "CostAggregation_0/Conv_0")[:, 0]
    disp, conf = soft_argmin(-cost, float(k))
    scales = [2 ** i for i in range(df - 1, -1, -1)] if model["hierarchical_refinement"] else [1]
    for i, s in enumerate(scales):
        while disp.shape[1] < h_full // s:
            disp = F.interpolate(disp[:, None], scale_factor=2, mode="bilinear",
                                 align_corners=False)[:, 0]
        guide = F.avg_pool2d(left, s) if s > 1 else left
        net = f"RefinementNet_{i}"
        y = conv_block(torch.cat([disp[:, None], guide], 1), p, net + "/ConvBlock_0")
        for j in range(_blocks(p, net)):
            y = res_block(y, p, f"{net}/ResBlock2D_{j}", DILATIONS[j % len(DILATIONS)])
        disp = torch.relu(disp + conv2d(y, p, net + "/Conv_0")[:, 0])
    return {"disparity": disp, "confidence": conf}

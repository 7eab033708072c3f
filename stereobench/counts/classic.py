"""Census of the CLASSIC StereoNet for one frame."""

from __future__ import annotations

from .common import Census, act_bytes, feature_tower, same_out

DILATED_BLOCKS = 6


def census(model: dict, height: int, width: int) -> Census:
    c = Census(act_bytes(model["compute_dtype"]))
    h, w = feature_tower(c, model, height, width)
    df = model["downsample_factor"]
    d = model["max_disparity"] // 2 ** df
    cin, agg = model["feature_channels"], model["aggregation_channels"]
    for i in range(model["num_aggregation_layers"]):
        c.conv(f"CostAggregation_0/ConvBlock3D_{i}/Conv_0", cin, agg, 27, d * h * w)
        c.group_norm(f"CostAggregation_0/ConvBlock3D_{i}/GroupNorm_0", agg * d * h * w, False)
        cin = agg
    c.conv("CostAggregation_0/Conv_0", cin, 1, 27, d * h * w)
    scales = [2 ** i for i in range(df - 1, -1, -1)] if model["hierarchical_refinement"] else [1]
    for i, s in enumerate(scales):
        ch = model["refinement_channels"]
        blocks = model["num_refinement_res_blocks"]
        if model.get("refinement_scale_channels"):
            sc = model["refinement_scale_channels"]
            ch = sc[min(i, len(sc) - 1)]
        if model.get("refinement_scale_blocks"):
            sb = model["refinement_scale_blocks"]
            blocks = sb[min(i, len(sb) - 1)]
        pos = same_out(height, s) * same_out(width, s)
        net = f"RefinementNet_{i}"
        c.conv_block(net + "/ConvBlock_0", 1 + model["input_channels"], ch, 9, pos)
        for j in range(blocks):
            c.res_block(f"{net}/ResBlock2D_{j}", ch, pos)
        c.conv(net + "/Conv_0", ch, 1, 9, pos)
    return c

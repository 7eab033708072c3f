"""Census of FastStereoNet (the flagship) for one frame."""

from __future__ import annotations

from .common import Census, act_bytes, feature_tower


def census(model: dict, height: int, width: int) -> Census:
    c = Census(act_bytes(model["compute_dtype"]))
    h, w = feature_tower(c, model, height, width)
    k = 2 ** model["downsample_factor"]
    d = model["max_disparity"] // k
    agg = max(model["aggregation_channels"], 64)
    c.conv_block("CorrelationAggregation2D_0/ConvBlock_0", d + model["feature_channels"], agg, 9,
                 h * w)
    for i in range(model["num_aggregation_layers"]):
        c.res_block(f"CorrelationAggregation2D_0/ResBlock2D_{i}", agg, h * w)
    c.conv("CorrelationAggregation2D_0/Conv_0", agg, d, 9, h * w)
    c.conv_block("upsample_mask_hidden", agg, 64, 9, h * w)
    c.conv("upsample_mask", 64, 9 * k * k, 9, h * w)
    return c

"""Shared arithmetic of the census: the work of one frame (a stereo pair) worked
out from layer shapes, the geometry and the network's widths, never from which
kernel computes a layer.

A conv counts 2 FLOPs a multiply-add: 2 * Cin * taps * Cout * output positions,
as ``torch.utils.flop_counter`` counts it.  A GroupNorm counts its input read
once, its residual input (where a skip is added) read once and its output
written once, at the activation's bytes an element; bias, statistics and
parameters are left out (under 0.1 %).  The ingest reads the frame's NV12 bytes
once and writes the model input once.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def same_out(size: int, stride: int) -> int:
    return -(-size // stride)


@dataclass
class Census:
    """Per-frame work, layer by layer."""
    act_bytes: int = 2
    convs: list = field(default_factory=list)        # (name, flops)
    group_norms: list = field(default_factory=list)  # (name, elements, has_skip)

    def conv(self, name: str, cin: int, cout: int, taps: int, positions: int) -> None:
        self.convs.append((name, 2 * cin * taps * cout * positions))

    def group_norm(self, name: str, elements: int, skip: bool) -> None:
        self.group_norms.append((name, elements, skip))

    def conv_block(self, name, cin, cout, taps, positions):
        self.conv(name + "/Conv_0", cin, cout, taps, positions)
        self.group_norm(name + "/GroupNorm_0", cout * positions, False)

    def res_block(self, name, c, positions):
        self.conv_block(name + "/ConvBlock_0", c, c, 9, positions)
        self.conv(name + "/Conv_0", c, c, 9, positions)
        self.group_norm(name + "/GroupNorm_0", c * positions, True)

    @property
    def conv_flops(self) -> int:
        return sum(f for _, f in self.convs)

    @property
    def group_norm_bytes(self) -> int:
        return sum(n * (3 if skip else 2) * self.act_bytes for _, n, skip in self.group_norms)


def feature_tower(c: Census, model: dict, height: int, width: int, eyes: int = 2):
    """The shared tower over both eyes; returns the feature map's (h, w)."""
    h, w, cin = height, width, model["input_channels"]
    ch = model["feature_channels"]
    for i in range(model["downsample_factor"]):
        h, w = same_out(h, 2), same_out(w, 2)
        c.conv_block(f"FeatureTower_0/ConvBlock_{i}", cin, ch, 25, eyes * h * w)
        cin = ch
    for i in range(model["num_feature_res_blocks"]):
        c.res_block(f"FeatureTower_0/ResBlock2D_{i}", ch, eyes * h * w)
    c.conv("FeatureTower_0/Conv_0", ch, ch, 9, eyes * h * w)
    return h, w


def ingest_bytes(height: int, width: int, color_space: str) -> int:
    """NV12 bytes of the side-by-side frame read, plus the [H, W, 6] model input
    written (bf16 YUV, float32 RGB)."""
    out = height * width * 6 * (2 if color_space == "yuv" else 4)
    return height * 2 * width * 3 // 2 + out


def act_bytes(compute_dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[compute_dtype]

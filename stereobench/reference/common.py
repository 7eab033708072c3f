"""Plain float32 pieces both reference networks share.

Independent of the program under test: plain ``torch`` operations in float32
with TF32 off, and its own ``.npz`` reader, layout conversion, NV12 ingest and
depth.  The layer semantics are the published networks' as the trained
weights were made with them (flax): "SAME" padding (for a 5x5 stride-2 conv on
an even size, one row before and two after), GroupNorm with eps 1e-6 over
groups of C/G channels, LeakyReLU with slope 0.2 after a residual add.

Parameters are a flat ``{flax path: array}`` dict, as the ``.npz`` holds them
(``FeatureTower_0/ConvBlock_0/Conv_0/kernel``); conv kernels are HWIO (DHWIO
for 3-D) there.
"""

from __future__ import annotations

import contextlib
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

GN_EPS = 1e-6
SLOPE = 0.2


def load_npz(path: str) -> dict:
    """{flax path: float32 array} of an ``.npz`` of parameters."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                out[name.removesuffix(".npy")] = np.lib.format.read_array(f).astype(np.float32)
    return out


class Params:
    """The parameters of one network as float32 tensors on ``device``, looked
    up by flax module path; conv kernels in torch's O, I, *taps layout."""

    def __init__(self, flat: dict, device):
        self._t = {}
        for key, arr in flat.items():
            t = torch.as_tensor(arr, dtype=torch.float32)
            if key.endswith("/kernel"):
                t = t.permute(t.dim() - 1, t.dim() - 2, *range(t.dim() - 2))
            self._t[key] = t.contiguous().to(device)

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._t[key]

    def has(self, prefix: str) -> bool:
        return any(k.startswith(prefix + "/") for k in self._t)


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions and matrix products without TF32 on the card."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def same_pads(size: int, kernel: int, stride: int, dilation: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p: Params, path: str, stride: int = 1, dilation: int = 1):
    w = p[path + "/kernel"]
    ph = same_pads(x.shape[2], w.shape[2], stride, dilation)
    pw = same_pads(x.shape[3], w.shape[3], stride, dilation)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, p[path + "/bias"], stride, 0, dilation)


def conv3d(x: torch.Tensor, p: Params, path: str):
    w = p[path + "/kernel"]
    return F.conv3d(x, w, p[path + "/bias"], 1, w.shape[2] // 2)


def num_groups(c: int) -> int:
    return next(g for g in (8, 4, 2, 1) if c % g == 0)


def group_norm(x: torch.Tensor, p: Params, path: str) -> torch.Tensor:
    return F.group_norm(x, num_groups(x.shape[1]), p[path + "/scale"], p[path + "/bias"], GN_EPS)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def conv_block(x, p, path, stride=1, dilation=1):
    """Conv + GroupNorm + LeakyReLU."""
    return leaky(group_norm(conv2d(x, p, path + "/Conv_0", stride, dilation), p,
                            path + "/GroupNorm_0"))


def res_block(x, p, path, dilation=1):
    """Two 3x3 convs with a skip; LeakyReLU after the add."""
    y = conv_block(x, p, path + "/ConvBlock_0", 1, dilation)
    y = group_norm(conv2d(y, p, path + "/Conv_0", 1, dilation), p, path + "/GroupNorm_0")
    return leaky(x + y)


def feature_tower(x, p, downsample: int = 3, res_blocks: int = 6):
    """[N, 3, H, W] -> [N, 32, H/8, W/8]: stride-2 5x5 blocks, residual blocks,
    a 3x3 projection."""
    for i in range(downsample):
        x = conv_block(x, p, f"FeatureTower_0/ConvBlock_{i}", stride=2)
    for i in range(res_blocks):
        x = res_block(x, p, f"FeatureTower_0/ResBlock2D_{i}")
    return conv2d(x, p, "FeatureTower_0/Conv_0")


def soft_argmin(logits: torch.Tensor, scale: float):
    """Logits [B, D, h, w] -> (disparity scale * sum_d d p_d, confidence max_d p_d)."""
    prob = torch.softmax(logits, dim=1)
    d = torch.arange(logits.shape[1], dtype=prob.dtype, device=prob.device).view(1, -1, 1, 1)
    return (prob * d).sum(1) * scale, prob.amax(1)


def nv12_to_input(sbs: torch.Tensor, height: int, width: int, color_space: str) -> torch.Tensor:
    """Side-by-side NV12 uint8 frames [B, L] -> (left, right) [B, 3, H, W]
    float32, normalized as ``(x - 128) / 128``: YUV444 (chroma repeated over each
    2x2 quad) or, with ``color_space="rgb"``, BT.601 full-range RGB clipped to
    [0, 255]."""
    b, h, fw = sbs.shape[0], height, 2 * width
    y = sbs[:, :h * fw].reshape(b, h, fw).float()
    uv = sbs[:, h * fw:].reshape(b, h // 2, fw // 2, 2).float()
    uv = uv.repeat_interleave(2, 1).repeat_interleave(2, 2)
    yc, u, v = y, uv[..., 0], uv[..., 1]
    if color_space == "rgb":
        bl = yc + (u - 128.0) / 0.492
        r = yc + (v - 128.0) / 0.877
        g = (yc - 0.299 * r - 0.114 * bl) / 0.587
        planes = [r, g, bl]
    elif color_space == "yuv":
        planes = [yc, u, v]
    else:
        raise ValueError(f"unknown color space {color_space!r}")
    img = torch.stack(planes, 1)
    if color_space == "rgb":
        img = img.clamp(0.0, 255.0)
    img = (img - 128.0) / 128.0
    return img[..., :width], img[..., width:]


def depth_m(disparity: torch.Tensor, focal_px: float, baseline_mm: float) -> torch.Tensor:
    """Metric depth of a disparity in pixels: f * B / max(d, 1e-6) / 1000 (B in mm)."""
    return (focal_px * baseline_mm) / torch.clamp(disparity, min=1e-6) / 1000.0

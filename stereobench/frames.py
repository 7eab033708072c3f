"""The benchmark's frames: synthetic side-by-side NV12 stereo pairs made on the device.

A torch copy of the procedure of ``hobot_stereonet_tpu_torch/data/synthetic.py::
generate_pair`` (layered, slanted and curved textured surfaces, a right view
rendered by inverse warping, photometric asymmetry and sensor noise), run where
the frames are used so that set-up does not pay the host generator's seconds a
pair.  The few scalars of a scene (layer boxes, disparities, slants) come from
a host ``numpy`` generator, the textures and noise from a ``torch.Generator``
on the device, both seeded from ``(seed, pair)``.  The same seed on the same
device and library versions gives the same bytes.

Each pair is converted to the camera's wire format, one flat side-by-side NV12
buffer (BT.601 full range, chroma averaged over each 2x2 quad, rounded half to
even), as ``data/stream.py::rgb_pair_to_sbs_nv12`` lays it out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MIN_DISPARITY = 2.0
MAX_DISPARITY = 48.0
NUM_LAYERS = 6
TEXTURE_SCALES = (4, 8, 16, 32)
NOISE_STD = 2.0
MAX_SLANT = 0.12
CURVATURE_AMP = 1.5
TEXTURELESS_PROB = 0.2
GAIN_RANGE = 0.10
BIAS_RANGE = 8.0
VIGNETTE_MAX = 0.15


def frame_bytes(height: int, width: int) -> int:
    """Bytes of one side-by-side NV12 frame of two ``height`` x ``width`` eyes."""
    return height * (2 * width) * 3 // 2


def _texture(g: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    img = torch.zeros((h, w, 3), device=device)
    for s in TEXTURE_SCALES:
        coarse = torch.rand((-(-h // s), -(-w // s), 3), generator=g, device=device)
        img += coarse.repeat_interleave(s, 0).repeat_interleave(s, 1)[:h, :w]
    img -= img.min()
    img /= torch.clamp(img.max(), min=1e-6)
    return img * 255.0


class _DispField:
    """A layer's analytic disparity: plane + sinusoidal curvature, clipped."""

    def __init__(self, rng: np.random.Generator, h: int, w: int, d0: float):
        self.d0 = d0
        self.gx = float(rng.uniform(-MAX_SLANT, MAX_SLANT))
        self.gy = float(rng.uniform(-MAX_SLANT, MAX_SLANT))
        self.cx = float(rng.uniform(0, w))
        self.cy = float(rng.uniform(0, h))
        amp = float(rng.uniform(0, CURVATURE_AMP))
        k = 2 * math.pi / float(rng.uniform(w / 3, w))
        self.amp, self.k = min(amp, 0.25 / k), k
        self.phx = float(rng.uniform(0, 2 * math.pi))
        self.phy = float(rng.uniform(0, 2 * math.pi))

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = (self.d0 + self.gx * (x - self.cx) + self.gy * (y - self.cy)
             + self.amp * torch.sin(self.k * x + self.phx) * torch.sin(self.k * y + self.phy))
        return torch.clamp(d, MIN_DISPARITY, MAX_DISPARITY)


def _sample_rows(canvas: torch.Tensor, mask: torch.Tensor, xmap: torch.Tensor):
    """out[y, x] = canvas[y, xmap[y, x]], bilinear along x; the mask AND-ed
    over both taps."""
    wc = canvas.shape[1]
    x0 = torch.floor(xmap)
    frac = (xmap - x0)[..., None]
    x0 = x0.long()
    inb = (x0 >= 0) & (x0 + 1 < wc)
    x0c = x0.clamp(0, wc - 2)
    x1c = x0c + 1
    left = torch.gather(canvas, 1, x0c[..., None].expand(-1, -1, 3))
    right = torch.gather(canvas, 1, x1c[..., None].expand(-1, -1, 3))
    out = left * (1 - frac) + right * frac
    m = inb & torch.gather(mask, 1, x0c) & torch.gather(mask, 1, x1c)
    return out, m


def _pair(rng: np.random.Generator, g: torch.Generator, h: int, w: int, device):
    """(left, right) RGB uint8 [h, w, 3] of one scene."""
    pad = int(math.ceil(MAX_DISPARITY)) + 4
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)

    bg_field = _DispField(rng, h, w, float(rng.uniform(MIN_DISPARITY, MIN_DISPARITY + 4.0)))
    bg = _texture(g, h, w + 2 * pad, device)
    if rng.random() < 0.5:                      # a matte, low-texture patch
        mh, mw = int(rng.integers(h // 6, h // 2)), int(rng.integers(w // 6, w // 2))
        my, mx = int(rng.integers(0, h - mh + 1)), int(rng.integers(0, bg.shape[1] - mw + 1))
        region = bg[my:my + mh, mx:mx + mw]
        region.copy_(0.15 * region + 0.85 * region.mean(dim=(0, 1), keepdim=True))
    layers = [(bg, torch.ones((h, w + 2 * pad), dtype=torch.bool, device=device), bg_field)]
    d0s = np.sort(rng.uniform(MIN_DISPARITY + 4.0, MAX_DISPARITY - CURVATURE_AMP,
                              size=NUM_LAYERS))
    for d0 in d0s:
        lw, lh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
        x0, y0 = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 8))
        x1, y1 = min(x0 + lw, w), min(y0 + lh, h)
        canvas = torch.zeros((h, w + 2 * pad, 3), device=device)
        mask = torch.zeros((h, w + 2 * pad), dtype=torch.bool, device=device)
        if rng.random() < TEXTURELESS_PROB:
            color = torch.as_tensor(rng.uniform(40, 215, size=3), dtype=torch.float32,
                                    device=device)
            tex = color + torch.randn((y1 - y0, x1 - x0, 3), generator=g, device=device)
        else:
            tex = _texture(g, y1 - y0, x1 - x0, device)
        canvas[y0:y1, pad + x0:pad + x1] = tex
        mask[y0:y1, pad + x0:pad + x1] = True
        layers.append((canvas, mask, _DispField(rng, h, w, float(d0))))

    left = torch.zeros((h, w, 3), device=device)
    right = torch.zeros((h, w, 3), device=device)
    for canvas, mask, field in layers:
        lm = mask[:, pad:pad + w]
        left = torch.where(lm[..., None], canvas[:, pad:pad + w], left)
        xl = xs + field(xs, ys)
        for _ in range(3):
            xl = xs + field(xl, ys)
        rt, rm = _sample_rows(canvas, mask, xl + pad)
        right = torch.where(rm[..., None], rt, right)

    gain = 1.0 + float(rng.uniform(-GAIN_RANGE, GAIN_RANGE))
    bias = float(rng.uniform(-BIAS_RANGE, BIAS_RANGE))
    right = right * gain + bias
    vstr = float(rng.uniform(0, VIGNETTE_MAX))
    if vstr > 0:
        r2 = ((ys - h / 2) / (h / 2)) ** 2 + ((xs - w / 2) / (w / 2)) ** 2
        right = right * (1.0 - vstr * r2 / 2.0)[..., None]
    left = left + NOISE_STD * torch.randn((h, w, 3), generator=g, device=device)
    right = right + NOISE_STD * torch.randn((h, w, 3), generator=g, device=device)
    # float -> uint8 truncates toward zero after the clip, as numpy's astype does.
    return (torch.clamp(left, 0, 255).to(torch.uint8), torch.clamp(right, 0, 255).to(torch.uint8))


def rgb_to_sbs_nv12(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two RGB uint8 [h, w, 3] eyes -> one flat side-by-side NV12 uint8 buffer."""
    rgb = torch.cat([left, right], dim=1).float()
    r, g, b = rgb.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) * 0.492 + 128.0
    v = (r - y) * 0.877 + 128.0
    h, fw = y.shape
    uv = torch.stack([u, v], -1).reshape(h // 2, 2, fw // 2, 2, 2).mean(dim=(1, 3))
    y8 = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    uv8 = torch.clamp(torch.round(uv), 0, 255).to(torch.uint8)
    return torch.cat([y8.reshape(-1), uv8.reshape(-1)])


def make_pool(seed: int, n: int, height: int, width: int, device) -> torch.Tensor:
    """``n`` distinct frames of the scene generator as one [n, L] uint8 tensor on
    ``device``; frame ``i`` depends on ``(seed, i)`` alone."""
    device = torch.device(device)
    out = torch.empty((n, frame_bytes(height, width)), dtype=torch.uint8, device=device)
    for i in range(n):
        rng = np.random.default_rng([seed % 2**63, i])
        g = torch.Generator(device=device)
        g.manual_seed(int(rng.integers(0, 2**62)))
        out[i] = rgb_to_sbs_nv12(*_pair(rng, g, height, width, device))
    return out

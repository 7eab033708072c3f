"""Procedural stereo scene generator with exact ground-truth disparity.

The environment has no SceneFlow/KITTI data (zero egress), and the reference
itself ships only two fixture JPEGs (``preprocess.h:45-48``).  This module
generates layered scenes — a background surface plus textured rectangles at
nearer depths — and renders the right view by inverse-warping each layer
through its analytic disparity field (back-to-front compositing), which
yields (sub)pixel-exact GT disparity with physically correct occlusion:
exactly what's needed to train and to regression-test EPE end to end.

v2 hardening (round-2: break the "every surface is fronto-parallel"
circularity): each layer carries a *disparity field* — plane slant
(d/dx, d/dy gradients) plus a sinusoidal curvature term — so disparity
varies per pixel within a surface; layers can be near-textureless; and the
right eye gets photometric asymmetry (gain/bias/vignette), all of which
real rigs exhibit and fronto-parallel constant-shift scenes never do.

A numpy-only copy of ``hobot_stereonet_tpu/data/synthetic.py``: the same
seed gives the same scene, bit for bit (``tests/test_torch_data.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticConfig:
    height: int = 256
    width: int = 512
    num_layers: int = 6
    min_disparity: float = 2.0
    max_disparity: float = 48.0
    texture_scales: Tuple[int, ...] = (4, 8, 16, 32)
    noise_std: float = 2.0  # sensor noise (uint8 counts)
    # --- v2 scene hardening ------------------------------------------------
    # Max |∂d/∂x|, |∂d/∂y| of a layer's disparity plane (px/px).  Slanted
    # surfaces make per-pixel-varying disparity the norm, not the exception.
    max_slant: float = 0.12
    # Amplitude (px) of the sinusoidal curvature term added to layer planes.
    curvature_amp: float = 1.5
    # Probability that a foreground layer is near-textureless (flat color),
    # forcing the network to interpolate from context like real walls/sky.
    textureless_prob: float = 0.2
    # Per-eye photometric asymmetry: right-eye gain in [1-g, 1+g], bias in
    # [-b, b] counts, plus a random vignette — exposure/optics never match
    # exactly between real cameras.  Set False for parity/debug scenes.
    photometric_asymmetry: bool = True
    gain_range: float = 0.10
    bias_range: float = 8.0
    vignette_max: float = 0.15


def _texture(rng: np.random.Generator, h: int, w: int, scales) -> np.ndarray:
    """Multi-scale random RGB texture in [0,255] — enough structure for
    matching to be well-posed at every scale."""
    img = np.zeros((h, w, 3), np.float32)
    for s in scales:
        coarse = rng.uniform(0, 1, size=(-(-h // s), -(-w // s), 3))
        up = np.kron(coarse, np.ones((s, s, 1)))[:h, :w, :]
        img += up.astype(np.float32)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img * 255.0


class _DispField:
    """Analytic per-layer disparity d(x, y): plane + sinusoidal curvature,
    clipped to the config's disparity range.  Analytic (not rasterized) so
    the right-view inverse warp can evaluate it at fractional coordinates
    with zero interpolation error."""

    def __init__(self, rng: np.random.Generator, cfg: SyntheticConfig,
                 d0: float):
        self.d0 = d0
        self.gx = float(rng.uniform(-cfg.max_slant, cfg.max_slant))
        self.gy = float(rng.uniform(-cfg.max_slant, cfg.max_slant))
        self.cx = float(rng.uniform(0, cfg.width))
        self.cy = float(rng.uniform(0, cfg.height))
        amp = float(rng.uniform(0, cfg.curvature_amp))
        # Keep total |dd/dx| < 0.5 so the fixed-point inverse warp converges
        # fast and layers never self-occlude.
        wavelength = float(rng.uniform(cfg.width / 3, cfg.width))
        k = 2 * np.pi / wavelength
        if amp * k > 0.25:
            amp = 0.25 / k
        self.amp, self.k = amp, k
        self.phx = float(rng.uniform(0, 2 * np.pi))
        self.phy = float(rng.uniform(0, 2 * np.pi))
        self.lo = cfg.min_disparity
        self.hi = cfg.max_disparity

    def __call__(self, x, y):
        d = (
            self.d0
            + self.gx * (x - self.cx)
            + self.gy * (y - self.cy)
            + self.amp * np.sin(self.k * x + self.phx) * np.sin(self.k * y + self.phy)
        )
        return np.clip(d, self.lo, self.hi).astype(np.float32)


def _layer_texture(rng: np.random.Generator, h: int, w: int,
                   cfg: SyntheticConfig, allow_textureless: bool) -> np.ndarray:
    if allow_textureless and rng.random() < cfg.textureless_prob:
        color = rng.uniform(40, 215, size=(1, 1, 3))
        return (color + rng.normal(0, 1.0, (h, w, 3))).astype(np.float32)
    return _texture(rng, h, w, cfg.texture_scales)


def _sample_row_bilinear(canvas: np.ndarray, mask: np.ndarray,
                         xmap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel horizontal resample: out[y, x] = canvas[y, xmap[y, x]] with
    bilinear interpolation along x (rows are axis-aligned — rectified stereo
    has no vertical parallax).  Mask is AND-ed over both taps."""
    h, W = canvas.shape[:2]
    x0 = np.floor(xmap).astype(np.int64)
    frac = (xmap - x0)[..., None]
    inb = (x0 >= 0) & (x0 + 1 < W)
    x0c = np.clip(x0, 0, W - 2)
    rows = np.arange(h)[:, None]
    out = canvas[rows, x0c] * (1 - frac) + canvas[rows, x0c + 1] * frac
    m = inb & mask[rows, x0c] & mask[rows, x0c + 1]
    return out.astype(np.float32), m


def generate_pair(
    rng: np.random.Generator, cfg: SyntheticConfig = SyntheticConfig()
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (left_rgb uint8 [H,W,3], right_rgb uint8, disparity float32 [H,W]).

    Disparity is defined on the left image; occluded-in-right regions keep
    their left-layer disparity (standard GT convention — SceneFlow GT is
    also defined on the left view including occlusions).

    Geometry: each layer is a textured surface with analytic disparity field
    D(x, y).  Left view samples the layer canvas at integer x (crisp); the
    right view at column x_r shows the layer point x_l solving
    x_l - D(x_l, y) = x_r, found by fixed-point iteration (converges since
    |dD/dx| < 0.5 by construction).  Compositing far-to-near gives correct
    occlusion in both views.
    """
    h, w = cfg.height, cfg.width
    pad = int(np.ceil(cfg.max_disparity)) + 4  # canvas margin for the warp

    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    xs2 = np.broadcast_to(xs, (h, w))
    ys2 = np.broadcast_to(ys, (h, w))

    # --- build layers far -> near (sorted by nominal disparity d0) --------
    layers = []  # (canvas [h, w+2*pad, 3], mask, field)
    bg_d0 = float(rng.uniform(cfg.min_disparity, cfg.min_disparity + 4.0))
    bg_field = _DispField(rng, cfg, bg_d0)
    bg_canvas = _texture(rng, h, w + 2 * pad, cfg.texture_scales)
    # Matte patch: blend a random background region toward its mean color —
    # a low-texture area (wall/sky analog) the matcher can't lock onto.
    if rng.random() < 0.5:
        mh = int(rng.integers(h // 6, h // 2))
        mw = int(rng.integers(w // 6, w // 2))
        my = int(rng.integers(0, h - mh + 1))
        mx = int(rng.integers(0, bg_canvas.shape[1] - mw + 1))
        region = bg_canvas[my : my + mh, mx : mx + mw]
        region[:] = 0.15 * region + 0.85 * region.mean(axis=(0, 1), keepdims=True)
    layers.append((bg_canvas, np.ones((h, w + 2 * pad), bool), bg_field))

    d0s = np.sort(
        rng.uniform(cfg.min_disparity + 4.0, cfg.max_disparity - cfg.curvature_amp,
                    size=cfg.num_layers)
    )
    for d0 in d0s:
        lw = int(rng.integers(w // 8, w // 2))
        lh = int(rng.integers(h // 8, h // 2))
        x0 = int(rng.integers(0, w - 8))
        y0 = int(rng.integers(0, h - 8))
        x1, y1 = min(x0 + lw, w), min(y0 + lh, h)
        canvas = np.zeros((h, w + 2 * pad, 3), np.float32)
        mask = np.zeros((h, w + 2 * pad), bool)
        canvas[y0:y1, pad + x0 : pad + x1] = _layer_texture(
            rng, y1 - y0, x1 - x0, cfg, allow_textureless=True
        )
        mask[y0:y1, pad + x0 : pad + x1] = True
        layers.append((canvas, mask, _DispField(rng, cfg, float(d0))))

    # --- composite both views far -> near ---------------------------------
    left = np.zeros((h, w, 3), np.float32)
    right = np.zeros((h, w, 3), np.float32)
    disp = np.zeros((h, w), np.float32)
    for canvas, mask, field in layers:
        # Left view: integer sampling at canvas x + pad.
        lm = mask[:, pad : pad + w]
        lt = canvas[:, pad : pad + w]
        d_here = field(xs2, ys2)
        left = np.where(lm[..., None], lt, left)
        disp = np.where(lm, d_here, disp)
        # Right view: solve x_l = x_r + D(x_l, y) by fixed point.
        xl = xs2 + d_here
        for _ in range(3):
            xl = xs2 + field(xl, ys2)
        rt, rm = _sample_row_bilinear(canvas, mask, xl + pad)
        right = np.where(rm[..., None], rt, right)

    # --- photometric asymmetry (right eye) ---------------------------------
    if cfg.photometric_asymmetry:
        gain = 1.0 + float(rng.uniform(-cfg.gain_range, cfg.gain_range))
        bias = float(rng.uniform(-cfg.bias_range, cfg.bias_range))
        right = right * gain + bias
        vstr = float(rng.uniform(0, cfg.vignette_max))
        if vstr > 0:
            r2 = ((ys2 - h / 2) / (h / 2)) ** 2 + ((xs2 - w / 2) / (w / 2)) ** 2
            right = right * (1.0 - vstr * r2 / 2.0)[..., None]

    if cfg.noise_std > 0:
        left = left + rng.normal(0, cfg.noise_std, left.shape)
        right = right + rng.normal(0, cfg.noise_std, right.shape)

    left = np.clip(left, 0, 255).astype(np.uint8)
    right = np.clip(right, 0, 255).astype(np.uint8)
    return left, right, disp


def generate_batch(rng: np.random.Generator, batch: int,
                   cfg: SyntheticConfig = SyntheticConfig()):
    """(left [B,H,W,3] u8, right [B,H,W,3] u8, disp [B,H,W] f32)."""
    ls, rs, ds = [], [], []
    for _ in range(batch):
        l, r, d = generate_pair(rng, cfg)
        ls.append(l)
        rs.append(r)
        ds.append(d)
    return np.stack(ls), np.stack(rs), np.stack(ds)


class LayeredScene:
    """A fixed layered 3D scene renderable from a translating camera — the
    ground-truth world for visual-odometry tests.

    Layers are fronto-parallel textured planes at metric depths Z_i.  For a
    camera translated by (tx, ty) meters (no rotation), layer i's image
    shifts by (-f*tx/Z_i, -f*ty/Z_i) px; the right eye adds the stereo
    baseline.  Rendering composites back to front, giving exact GT
    disparity and exact GT poses for ATE evaluation.
    """

    def __init__(self, rng: np.random.Generator, height: int, width: int,
                 focal_px: float, baseline_m: float,
                 depths_m: Tuple[float, ...] = (12.0, 7.0, 4.5, 3.0),
                 texture_scales: Tuple[int, ...] = (4, 8, 16, 32)):
        self.h, self.w = height, width
        self.f = focal_px
        self.baseline_m = baseline_m
        self.depths = sorted(depths_m, reverse=True)  # far -> near
        pad = 256  # margin for camera motion
        self.pad = pad
        self.layers = []
        for li, z in enumerate(self.depths):
            if li == 0:
                tex = _texture(rng, height + 2 * pad, width + 2 * pad, texture_scales)
                tex += rng.uniform(-12, 12, tex.shape)  # per-pixel detail
                mask = np.ones(tex.shape[:2], bool)
            else:
                tex = np.zeros((height + 2 * pad, width + 2 * pad, 3), np.float32)
                mask = np.zeros(tex.shape[:2], bool)
                for _ in range(3):
                    lh = int(rng.integers(height // 6, height // 2))
                    lw = int(rng.integers(width // 6, width // 2))
                    y0 = int(rng.integers(pad // 2, height + pad))
                    x0 = int(rng.integers(pad // 2, width + pad))
                    # Clip to the padded canvas: at deployment geometries
                    # (H/2 > pad) an unclipped patch can overflow the
                    # texture; smaller geometries never clip, so existing
                    # scene seeds render bit-identically.
                    lh = min(lh, tex.shape[0] - y0)
                    lw = min(lw, tex.shape[1] - x0)
                    patch = _texture(rng, lh, lw, texture_scales)
                    patch += rng.uniform(-12, 12, patch.shape)
                    tex[y0 : y0 + lh, x0 : x0 + lw] = patch
                    mask[y0 : y0 + lh, x0 : x0 + lw] = True
            self.layers.append((z, tex, mask))

    def render(self, tx_m: float = 0.0, ty_m: float = 0.0):
        """Returns (left u8 [H,W,3], right u8, disparity f32 [H,W]) for a
        camera at (tx, ty, 0) with identity rotation."""
        h, w, pad = self.h, self.w, self.pad
        left = np.zeros((h, w, 3), np.float32)
        right = np.zeros((h, w, 3), np.float32)
        disp = np.zeros((h, w), np.float32)
        for z, tex, mask in self.layers:
            d_px = self.f * self.baseline_m / z
            ox = self.f * tx_m / z
            oy = self.f * ty_m / z
            lx, ly = pad + ox, pad + oy
            tl, ml = _bilinear_crop(tex, mask, ly, lx, h, w)
            tr, mr = _bilinear_crop(tex, mask, ly, lx + d_px, h, w)
            left = np.where(ml[..., None], tl, left)
            right = np.where(mr[..., None], tr, right)
            disp = np.where(ml, d_px, disp)
        return (
            np.clip(left, 0, 255).astype(np.uint8),
            np.clip(right, 0, 255).astype(np.uint8),
            disp,
        )

    def gt_center(self, tx_m: float, ty_m: float) -> np.ndarray:
        return np.array([tx_m, ty_m, 0.0], np.float32)


def generate_layered_hard(
    rng: np.random.Generator,
    height: int,
    width: int,
    focal_px: float = 320.0,
    baseline_m: float = 0.25,
    depths_m: Tuple[float, ...] = (16.0, 9.0, 5.0, 3.2, 2.2),
    texture_scales: Tuple[int, ...] = (4, 8, 16, 32),
    max_rel_slant: float = 0.5,
    frontal_prob: float = 0.3,
    patches_per_depth: int = 2,
    photometric_asymmetry: bool = True,
    gain_range: float = 0.18,
    bias_range: float = 12.0,
    vignette_max: float = 0.25,
    gamma_range: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hardened cross-distribution family: slanted metric planes + stronger
    per-eye photometrics (round-2 verdict: the fronto-parallel layered set
    was strictly *easier* than training; this one is not).

    Family identity vs. the training generator (``generate_pair``): layers
    are planes at metric depths (d0 = f*B/Z), disparity fields are exactly
    affine (a 3D plane's disparity is affine in image coordinates — no
    curvature term), textures are the LayeredScene kron+detail style, and
    there is NO sensor noise.  What makes it harder than round 2's version:

      * mixed slants — each plane tilts (affine disparity gradient up to
        ``max_rel_slant * d0`` of variation across its extent) with
        probability 1 - ``frontal_prob``;
      * right-eye photometrics the training distribution never shows:
        stronger gain/bias/vignette plus a GAMMA mismatch (nonlinear —
        training augmentation is affine-only, see loader.color_jitter).

    The right view is rendered by a CLOSED-FORM inverse warp: for affine
    d(x, y) the equation x_l - d(x_l, y) = x_r is linear in x_l, so GT
    disparity is exact to float precision (no fixed-point iteration).
    Returns (left u8 [H,W,3], right u8, disparity f32 [H,W]).
    """
    h, w = height, width
    fb = focal_px * baseline_m
    depths = sorted(depths_m, reverse=True)  # far -> near
    pad = int(np.ceil(fb / min(depths) * 1.6)) + 8

    ys2 = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    xs2 = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))

    def _plane(d0: float, bx: float, by: float, bw: float, bh: float):
        """Affine disparity plane centered on a bbox, variation capped at
        max_rel_slant * d0 so disparity stays positive layer-wide."""
        if rng.random() < frontal_prob:
            return d0, 0.0, 0.0, 0.0, 0.0
        gx = float(rng.uniform(-0.3, 0.3))
        gy = float(rng.uniform(-0.3, 0.3))
        cx, cy = bx + bw / 2.0, by + bh / 2.0
        var = abs(gx) * bw / 2.0 + abs(gy) * bh / 2.0
        limit = max_rel_slant * d0
        if var > limit and var > 0:
            s = limit / var
            gx, gy = gx * s, gy * s
        return d0, gx, gy, cx, cy

    # (canvas [h, w+2p, 3], mask, (d0, gx, gy, cx, cy)) far -> near
    layers = []
    for li, z in enumerate(depths):
        d0 = fb / z
        if li == 0:
            tex = _texture(rng, h, w + 2 * pad, texture_scales)
            tex += rng.uniform(-12, 12, tex.shape)
            layers.append((tex, np.ones((h, w + 2 * pad), bool),
                           _plane(d0, 0.0, 0.0, float(w), float(h))))
            continue
        canvas = np.zeros((h, w + 2 * pad, 3), np.float32)
        mask = np.zeros((h, w + 2 * pad), bool)
        ux0, uy0, ux1, uy1 = w, h, 0, 0  # union bbox of the layer's patches
        for _ in range(patches_per_depth):
            lw = int(rng.integers(w // 6, w // 2))
            lh = int(rng.integers(h // 6, h // 2))
            x0 = int(rng.integers(0, w - 8))
            y0 = int(rng.integers(0, h - 8))
            x1, y1 = min(x0 + lw, w), min(y0 + lh, h)
            patch = _texture(rng, y1 - y0, x1 - x0, texture_scales)
            patch += rng.uniform(-12, 12, patch.shape)
            canvas[y0:y1, pad + x0 : pad + x1] = patch
            mask[y0:y1, pad + x0 : pad + x1] = True
            ux0, uy0 = min(ux0, x0), min(uy0, y0)
            ux1, uy1 = max(ux1, x1), max(uy1, y1)
        # The slant cap spans the union bbox so disparity stays positive
        # over EVERY patch of this layer, not just the last one placed.
        layers.append((canvas, mask,
                       _plane(d0 * float(rng.uniform(0.9, 1.1)),
                              float(ux0), float(uy0),
                              float(ux1 - ux0), float(uy1 - uy0))))

    left = np.zeros((h, w, 3), np.float32)
    right = np.zeros((h, w, 3), np.float32)
    disp = np.zeros((h, w), np.float32)
    for canvas, mask, (d0, gx, gy, cx, cy) in layers:
        d_here = (d0 + gx * (xs2 - cx) + gy * (ys2 - cy)).astype(np.float32)
        lm = mask[:, pad : pad + w]
        left = np.where(lm[..., None], canvas[:, pad : pad + w], left)
        disp = np.where(lm, d_here, disp)
        # Closed-form inverse warp: x_l (1 - gx) = x_r + d0 - gx cx + gy (y - cy).
        xl = (xs2 + d0 - gx * cx + gy * (ys2 - cy)) / (1.0 - gx)
        rt, rm = _sample_row_bilinear(canvas, mask, xl + pad)
        right = np.where(rm[..., None], rt, right)

    if photometric_asymmetry:
        gamma = 1.0 + float(rng.uniform(-gamma_range, gamma_range))
        right = 255.0 * np.power(np.clip(right, 0.0, 255.0) / 255.0, gamma)
        gain = 1.0 + float(rng.uniform(-gain_range, gain_range))
        bias = float(rng.uniform(-bias_range, bias_range))
        right = right * gain + bias
        vstr = float(rng.uniform(0, vignette_max))
        if vstr > 0:
            r2 = ((ys2 - h / 2) / (h / 2)) ** 2 + ((xs2 - w / 2) / (w / 2)) ** 2
            right = right * (1.0 - vstr * r2 / 2.0)[..., None]

    return (
        np.clip(left, 0, 255).astype(np.uint8),
        np.clip(right, 0, 255).astype(np.uint8),
        disp,
    )


def _bilinear_crop(tex: np.ndarray, mask: np.ndarray, y0: float, x0: float,
                   h: int, w: int):
    """Sample tex[y0:y0+h, x0:x0+w] with bilinear interpolation; mask is
    AND-ed over the 4 corners (conservative)."""
    yi = np.arange(h, dtype=np.float64) + y0
    xi = np.arange(w, dtype=np.float64) + x0
    yf = np.floor(yi).astype(np.int64)
    xf = np.floor(xi).astype(np.int64)
    wy = (yi - yf)[:, None, None]
    wx = (xi - xf)[None, :, None]
    H, W = tex.shape[:2]
    yf0 = np.clip(yf, 0, H - 2)
    xf0 = np.clip(xf, 0, W - 2)
    t00 = tex[yf0[:, None], xf0[None, :]]
    t01 = tex[yf0[:, None], xf0[None, :] + 1]
    t10 = tex[yf0[:, None] + 1, xf0[None, :]]
    t11 = tex[yf0[:, None] + 1, xf0[None, :] + 1]
    out = (
        t00 * (1 - wy) * (1 - wx)
        + t01 * (1 - wy) * wx
        + t10 * wy * (1 - wx)
        + t11 * wy * wx
    )
    m = (
        mask[yf0[:, None], xf0[None, :]]
        & mask[yf0[:, None], xf0[None, :] + 1]
        & mask[yf0[:, None] + 1, xf0[None, :]]
        & mask[yf0[:, None] + 1, xf0[None, :] + 1]
    )
    return out.astype(np.float32), m

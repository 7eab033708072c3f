"""Visualization: disparity/depth colormaps and stereo composites.

Counterpart of ``hobot_stereonet_tpu/viz/colormap.py`` (numpy; PNG through
PIL, imported when a PNG is written).

Replaces the reference's render node (SURVEY.md C10:
``publisher_member_function.py`` — dequant, JET colormap via
``cv2.convertScaleAbs(alpha=9)`` + ``COLORMAP_JET``, vertical stack with
the left view, JPEG publish) with host-side PNG rendering — no OpenCV, no
ROS topics; the "web display" layer becomes files on disk / returned
arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Piecewise-linear JET (matches the classic OpenCV COLORMAP_JET ramp:
# blue -> cyan -> yellow -> red over [0, 255]).
def _jet_channel(v: np.ndarray, center: float) -> np.ndarray:
    return np.clip(1.5 - np.abs(v - center) * 4.0 / 255.0, 0.0, 1.0)


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """uint8 [H,W] -> RGB uint8 [H,W,3] JET."""
    v = x.astype(np.float32)
    r = _jet_channel(v, 255.0 * 0.75)
    g = _jet_channel(v, 255.0 * 0.5)
    b = _jet_channel(v, 255.0 * 0.25)
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)


def colorize_disparity(disp: np.ndarray, alpha: float = 9.0) -> np.ndarray:
    """Float disparity (px) -> JET RGB.  ``alpha=9`` mirrors the reference's
    ``convertScaleAbs(disp, alpha=9)`` scaling
    (``publisher_member_function.py:82``)."""
    scaled = np.clip(np.abs(disp) * alpha, 0, 255).astype(np.uint8)
    return jet_colormap(scaled)


def colorize_depth(depth_m: np.ndarray, max_depth_m: float = 10.0) -> np.ndarray:
    """Metric depth -> JET RGB (near = red, far = blue)."""
    scaled = np.clip(depth_m / max_depth_m, 0, 1)
    return jet_colormap(((1.0 - scaled) * 255).astype(np.uint8))


def stack_vertical(top_rgb: np.ndarray, bottom_rgb: np.ndarray) -> np.ndarray:
    """Left view over depth map — the reference's composite layout
    (``publisher_member_function.py:121-124``)."""
    w = max(top_rgb.shape[1], bottom_rgb.shape[1])

    def fit(img):
        if img.shape[1] == w:
            return img
        pad = w - img.shape[1]
        return np.pad(img, [(0, 0), (0, pad), (0, 0)])

    return np.concatenate([fit(top_rgb), fit(bottom_rgb)], axis=0)


def save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


def render_result(
    left_rgb: np.ndarray,
    disparity: np.ndarray,
    depth_m: Optional[np.ndarray] = None,
    alpha: float = 9.0,
) -> np.ndarray:
    """Full composite: left view stacked over colorized disparity (or depth),
    ready for save_png — the one-call equivalent of the render node."""
    bottom = (
        colorize_depth(depth_m) if depth_m is not None else colorize_disparity(disparity, alpha)
    )
    return stack_vertical(left_rgb, bottom)

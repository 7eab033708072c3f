"""KITTI 2015 stereo dataset loader (BASELINE.json config 2: EPE/D1-all).

Counterpart of ``hobot_stereonet_tpu/data/kitti.py``.

Layout: <root>/training/image_2/XXXXXX_10.png (left),
        <root>/training/image_3/XXXXXX_10.png (right),
        <root>/training/disp_occ_0/XXXXXX_10.png (uint16 disparity * 256,
        0 = invalid — the KITTI GT encoding).
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from .loader import StereoSample
from .sceneflow import _read_image


def read_kitti_disparity(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 PNG -> (disparity float32, valid mask).  disp = png / 256,
    0 means no ground truth."""
    from PIL import Image

    raw = np.asarray(Image.open(path), dtype=np.uint16).astype(np.float32)
    valid = raw > 0
    return raw / 256.0, valid


class Kitti2015Dataset:
    def __init__(self, root: str, split: str = "training"):
        self.left_paths = sorted(
            glob.glob(os.path.join(root, split, "image_2", "*_10.png"))
        )
        if not self.left_paths:
            raise FileNotFoundError(f"no KITTI 2015 images under {root!r}/{split}")
        self.split = split

    def __len__(self) -> int:
        return len(self.left_paths)

    def __getitem__(self, i: int) -> StereoSample:
        lp = self.left_paths[i]
        rp = lp.replace("image_2", "image_3")
        sample_left = _read_image(lp)
        sample_right = _read_image(rp)
        dp = lp.replace("image_2", "disp_occ_0")
        if os.path.exists(dp):
            disp, valid = read_kitti_disparity(dp)
            disp = np.where(valid, disp, 0.0).astype(np.float32)
        else:
            disp = np.zeros(sample_left.shape[:2], np.float32)
        return StereoSample(sample_left, sample_right, disp, name=lp)

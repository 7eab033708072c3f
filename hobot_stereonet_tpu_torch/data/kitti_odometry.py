"""KITTI odometry dataset loader: the port's copy of
``hobot_stereonet_tpu/data/kitti_odometry.py`` (numpy only).

Layout: <root>/sequences/NN/image_2/XXXXXX.png (left),
        <root>/sequences/NN/image_3/XXXXXX.png (right),
        <root>/sequences/NN/calib.txt (P2/P3 projection matrices),
        <root>/poses/NN.txt (3x4 world-from-camera GT poses, one per line,
        available for sequences 00-10).

Gated on path existence; provides GT camera centers for
``absolute_trajectory_error``.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import CameraConfig
from .sceneflow import _read_image


@dataclass
class OdometryFrame:
    left: np.ndarray
    right: np.ndarray
    gt_pose: Optional[np.ndarray] = None  # [3, 4] world-from-camera
    index: int = 0


def read_calib(path: str) -> CameraConfig:
    """Parse P2/P3 from calib.txt -> CameraConfig (f, baseline, size unset
    until first image)."""
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, rest = line.split(":", 1)
            vals[key.strip()] = np.fromstring(rest, sep=" ")
    p2 = vals["P2"].reshape(3, 4)
    p3 = vals["P3"].reshape(3, 4)
    f_px = float(p2[0, 0])
    # Baseline from the projection matrices: tx = -f * B  (P3 is the right
    # camera) => B = -(P3[0,3] - P2[0,3]) / f.
    baseline_m = float(-(p3[0, 3] - p2[0, 3]) / f_px)
    return CameraConfig(focal_px=f_px, baseline_mm=baseline_m * 1000.0)


def read_poses(path: str) -> np.ndarray:
    """poses/NN.txt -> [N, 3, 4] world-from-camera matrices."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows.astype(np.float32)


class KittiOdometrySequence:
    def __init__(self, root: str, sequence: str = "00"):
        seq_dir = os.path.join(root, "sequences", sequence)
        self.left_paths = sorted(glob.glob(os.path.join(seq_dir, "image_2", "*.png")))
        if not self.left_paths:
            raise FileNotFoundError(f"no KITTI odometry frames under {seq_dir}")
        calib = os.path.join(seq_dir, "calib.txt")
        self.camera = read_calib(calib) if os.path.exists(calib) else CameraConfig()
        pose_file = os.path.join(root, "poses", f"{sequence}.txt")
        self.gt_poses = read_poses(pose_file) if os.path.exists(pose_file) else None

    def __len__(self) -> int:
        return len(self.left_paths)

    def __getitem__(self, i: int) -> OdometryFrame:
        lp = self.left_paths[i]
        rp = lp.replace("image_2", "image_3")
        return OdometryFrame(
            left=_read_image(lp),
            right=_read_image(rp),
            gt_pose=self.gt_poses[i] if self.gt_poses is not None else None,
            index=i,
        )

    def gt_centers(self) -> Optional[np.ndarray]:
        """GT camera centers [N, 3] (poses are world-from-camera, so the
        translation column IS the camera center in world frame)."""
        if self.gt_poses is None:
            return None
        return self.gt_poses[:, :, 3]

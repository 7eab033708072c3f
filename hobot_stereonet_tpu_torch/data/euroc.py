"""EuRoC MAV dataset loader: the port's copy of
``hobot_stereonet_tpu/data/euroc.py`` (numpy only; KITTI odometry lives in
``kitti_odometry.py``).

ASL layout: <root>[/<sequence>]/mav0/
    cam0/sensor.yaml            intrinsics, radtan distortion, T_BS extrinsics
    cam0/data.csv               timestamp [ns], filename
    cam0/data/<ts>.png          left image (grayscale 752x480)
    cam1/...                    right camera
    state_groundtruth_estimate0/data.csv   ts, p_RS_R xyz, q_RS wxyz, ...

Unlike KITTI, EuRoC frames are UNRECTIFIED (radial-tangential fisheye-ish
lenses, converged optical axes), so this loader performs full Bouguet-style
stereo rectification on the host: undistort + rotate both cameras onto a
common image plane with the baseline along +x, producing epipolar-aligned
frames and a single rectified CameraConfig (f, B) — the contract the rest of
the framework (cost volumes scan along rows; depth = f*B/d) assumes.

All heavy work is two precomputed inverse remap grids per sequence; per-frame
cost is one vectorized bilinear gather. Gated on path existence like the
other loaders.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import CameraConfig
from .kitti_odometry import OdometryFrame
from .sceneflow import _read_image


# ---------------------------------------------------------------------------
# sensor.yaml parsing (tiny hand parser: only bracketed lists are needed, no
# YAML dependency)
# ---------------------------------------------------------------------------


@dataclass
class EurocCamera:
    T_BS: np.ndarray  # [4, 4] body-from-sensor
    intrinsics: np.ndarray  # [fu, fv, cu, cv]
    distortion: np.ndarray  # [k1, k2, p1, p2] radial-tangential
    resolution: Tuple[int, int]  # (width, height)


def _yaml_list(text: str, key: str) -> np.ndarray:
    m = re.search(rf"^\s*{key}\s*:\s*\[([^\]]*)\]", text, re.MULTILINE | re.DOTALL)
    if m is None:
        raise ValueError(f"key {key!r} not found in sensor.yaml")
    return np.fromstring(m.group(1).replace("\n", " "), sep=",")


def read_sensor_yaml(path: str) -> EurocCamera:
    with open(path) as f:
        text = f.read()
    t_bs = _yaml_list(text, "data").reshape(4, 4).astype(np.float64)
    intr = _yaml_list(text, "intrinsics").astype(np.float64)
    dist = _yaml_list(text, "distortion_coefficients").astype(np.float64)
    res = _yaml_list(text, "resolution").astype(int)
    return EurocCamera(t_bs, intr, dist, (int(res[0]), int(res[1])))


# ---------------------------------------------------------------------------
# Stereo rectification geometry
# ---------------------------------------------------------------------------


def stereo_rectify(cam0: EurocCamera, cam1: EurocCamera):
    """Bouguet-style rectification from the two body-from-sensor extrinsics.

    Returns (R_rect0, R_rect1, K_new, baseline_m):
      * ``R_rect{i}`` maps old cam-i coordinates -> rectified common frame,
      * in the rectified frame cam1 sits at ``[+baseline, 0, 0]`` from cam0
        (cam0 = left), so disparity is non-negative,
      * ``K_new`` is the shared rectified pinhole [fu, fv, cu, cv].
    """
    t_01 = np.linalg.inv(cam0.T_BS) @ cam1.T_BS  # cam0-from-cam1
    r_01 = t_01[:3, :3]
    b = t_01[:3, 3]  # cam1 origin in cam0 coords
    bnorm = float(np.linalg.norm(b))
    if bnorm <= 0:
        raise ValueError("degenerate rig: zero baseline")

    ex = b / bnorm  # new x-axis: along the baseline
    # New z-axis: mean of the two old optical axes, made orthogonal to ex.
    z_avg = np.array([0.0, 0.0, 1.0]) + r_01 @ np.array([0.0, 0.0, 1.0])
    ey = np.cross(z_avg, ex)
    ey /= np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    r_rect0 = np.stack([ex, ey, ez])  # rows = new axes in cam0 coords
    r_rect1 = r_rect0 @ r_01

    fu = float(cam0.intrinsics[0])
    fv = float(cam0.intrinsics[1])
    w, h = cam0.resolution
    k_new = np.array([fu, fv, (w - 1) / 2.0, (h - 1) / 2.0])
    return r_rect0, r_rect1, k_new, bnorm


def _distort_radtan(x: np.ndarray, y: np.ndarray, dist: np.ndarray):
    k1, k2, p1, p2 = [float(v) for v in dist[:4]]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def rectify_map(cam: EurocCamera, r_rect: np.ndarray, k_new: np.ndarray):
    """Inverse remap grid: for every rectified pixel, the source pixel in the
    raw (distorted) image. Returns (map_x, map_y) float32 [H, W]."""
    w, h = cam.resolution
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    # Rectified pixel -> ray in the rectified frame.
    x = (u - k_new[2]) / k_new[0]
    y = (v - k_new[3]) / k_new[1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)  # [H, W, 3]
    # Rotate back into the raw camera frame (r_rect maps old->new).
    rays_old = rays @ r_rect  # == rays @ (r_rect^T)^T, i.e. r_rect^T applied
    xo = rays_old[..., 0] / rays_old[..., 2]
    yo = rays_old[..., 1] / rays_old[..., 2]
    xd, yd = _distort_radtan(xo, yo, cam.distortion)
    fu, fv, cu, cv = [float(c) for c in cam.intrinsics]
    return (fu * xd + cu).astype(np.float32), (fv * yd + cv).astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Vectorized bilinear gather; out-of-range samples are black."""
    h, w = img.shape[:2]
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    x0c = np.clip(np.floor(map_x).astype(np.int64), 0, w - 2)
    y0c = np.clip(np.floor(map_y).astype(np.int64), 0, h - 2)
    # Fractions against the CLIPPED base so exact-edge samples (x == w-1)
    # interpolate to the edge texel instead of reading past it.
    fx = (map_x - x0c)[..., None]
    fy = (map_y - y0c)[..., None]
    p00 = img[y0c, x0c].astype(np.float32)
    p01 = img[y0c, x0c + 1].astype(np.float32)
    p10 = img[y0c + 1, x0c].astype(np.float32)
    p11 = img[y0c + 1, x0c + 1].astype(np.float32)
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    )
    out *= valid[..., None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Sequence
# ---------------------------------------------------------------------------


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[w, x, y, z] (EuRoC GT order) -> [3, 3] rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class EurocSequence:
    """Rectified stereo frames + nearest-timestamp GT poses for one sequence.

    ``root`` may point at the sequence directory itself (containing ``mav0``)
    or at a dataset root, with ``sequence`` naming the subdirectory
    (e.g. ``MH_01_easy``).
    """

    GT_TOLERANCE_NS = 25_000_000  # 25 ms (GT is 200 Hz => 5 ms spacing)

    def __init__(self, root: str, sequence: str = ""):
        base = os.path.join(root, sequence) if sequence else root
        mav = os.path.join(base, "mav0")
        if not os.path.isdir(mav):
            raise FileNotFoundError(f"no EuRoC mav0 directory under {base}")
        self.cam0 = read_sensor_yaml(os.path.join(mav, "cam0", "sensor.yaml"))
        self.cam1 = read_sensor_yaml(os.path.join(mav, "cam1", "sensor.yaml"))
        self.r_rect0, self.r_rect1, self.k_new, baseline_m = stereo_rectify(
            self.cam0, self.cam1
        )
        w, h = self.cam0.resolution
        self.camera = CameraConfig(
            focal_px=float(self.k_new[0]),
            baseline_mm=baseline_m * 1000.0,
            width=w,
            height=h,
        )
        self._map0 = rectify_map(self.cam0, self.r_rect0, self.k_new)
        self._map1 = rectify_map(self.cam1, self.r_rect1, self.k_new)

        self.left_paths = sorted(glob.glob(os.path.join(mav, "cam0", "data", "*.png")))
        if not self.left_paths:
            raise FileNotFoundError(f"no EuRoC frames under {mav}/cam0/data")
        self._cam1_dir = os.path.join(mav, "cam1", "data")
        self.timestamps_ns = np.array(
            [int(os.path.splitext(os.path.basename(p))[0]) for p in self.left_paths],
            dtype=np.int64,
        )
        self.gt_poses = self._load_gt(mav)

    def _load_gt(self, mav: str) -> Optional[np.ndarray]:
        """[N, 3, 4] world-from-rectified-cam0, nearest-GT-row per frame
        (NaN rows where no GT within tolerance)."""
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(gt_csv):
            return None
        raw = np.genfromtxt(gt_csv, delimiter=",", skip_header=1)
        if raw.ndim == 1:
            raw = raw[None]
        gt_ts = raw[:, 0].astype(np.int64)
        # Body-from-rectified-cam0 = T_BS(cam0) with the rectifying rotation
        # folded in (rectified frame -> old cam0 frame is r_rect0^T).
        t_b_rc0 = self.cam0.T_BS.copy()
        t_b_rc0[:3, :3] = t_b_rc0[:3, :3] @ self.r_rect0.T
        poses = np.full((len(self.timestamps_ns), 3, 4), np.nan, dtype=np.float32)
        idx = np.searchsorted(gt_ts, self.timestamps_ns)
        for i, (ts, j) in enumerate(zip(self.timestamps_ns, idx)):
            cands = [c for c in (j - 1, j) if 0 <= c < len(gt_ts)]
            if not cands:
                continue
            j_best = min(cands, key=lambda c: abs(int(gt_ts[c]) - int(ts)))
            if abs(int(gt_ts[j_best]) - int(ts)) > self.GT_TOLERANCE_NS:
                continue
            row = raw[j_best]
            t_wb = np.eye(4)
            t_wb[:3, :3] = _quat_to_rot(row[4:8])
            t_wb[:3, 3] = row[1:4]
            poses[i] = (t_wb @ t_b_rc0)[:3, :]
        return poses

    def __len__(self) -> int:
        return len(self.left_paths)

    def __getitem__(self, i: int) -> OdometryFrame:
        lp = self.left_paths[i]
        rp = os.path.join(self._cam1_dir, os.path.basename(lp))
        left = remap_bilinear(_read_image(lp), *self._map0)
        right = remap_bilinear(_read_image(rp), *self._map1)
        pose = None
        if self.gt_poses is not None and np.isfinite(self.gt_poses[i]).all():
            pose = self.gt_poses[i]
        return OdometryFrame(left=left, right=right, gt_pose=pose, index=i)

    def gt_centers(self) -> Optional[np.ndarray]:
        """GT rectified-cam0 centers [N, 3] (NaN where GT was missing)."""
        if self.gt_poses is None:
            return None
        return self.gt_poses[:, :, 3]


# ---------------------------------------------------------------------------
# Writing a sequence (fixtures: a rendered trajectory in the ASL layout)
# ---------------------------------------------------------------------------


def _write_sensor_yaml(path: str, t_bs: np.ndarray, intrinsics, resolution) -> None:
    rows = ",\n         ".join(", ".join(f"{v}" for v in t_bs[r]) for r in range(4))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n"
                f"  data: [{rows}]\nrate_hz: 20\n"
                f"resolution: [{resolution[0]}, {resolution[1]}]\ncamera_model: pinhole\n"
                f"intrinsics: [{', '.join(map(str, intrinsics))}]\n"
                "distortion_model: radial-tangential\n"
                "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")


def write_sequence(base: str, lefts, rights, centers: np.ndarray, focal_px: float,
                   baseline_m: float, t0_ns: int = 1403636579763555584,
                   period_ns: int = 50_000_000) -> None:
    """Write frames as an EuRoC ASL sequence under ``base`` (``base/mav0``):
    an ideal rectified rig (no distortion, cam1 ``baseline_m`` along +x,
    the principal point at the image centre, so rectifying is the
    identity), one PNG per frame and camera, and ground truth holding the
    camera centres ``centers`` [N, 3] with no rotation."""
    from PIL import Image

    h, w = np.asarray(lefts[0]).shape[:2]
    mav = os.path.join(base, "mav0")
    intr = [focal_px, focal_px, (w - 1) / 2.0, (h - 1) / 2.0]
    t1 = np.eye(4)
    t1[0, 3] = baseline_m
    for cam, t_bs in (("cam0", np.eye(4)), ("cam1", t1)):
        _write_sensor_yaml(os.path.join(mav, cam, "sensor.yaml"), t_bs, intr, (w, h))
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
    stamps = [t0_ns + i * period_ns for i in range(len(lefts))]
    for ts, left, right in zip(stamps, lefts, rights):
        Image.fromarray(np.asarray(left)).save(os.path.join(mav, "cam0", "data", f"{ts}.png"))
        Image.fromarray(np.asarray(right)).save(os.path.join(mav, "cam1", "data", f"{ts}.png"))
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for ts, c in zip(stamps, centers):
            f.write(f"{ts},{c[0]},{c[1]},{c[2]},1.0,0.0,0.0,0.0\n")

"""Sequence-level SLAM runners: drive the tracker over a dataset sequence
and score ATE against ground truth (``hobot_stereonet_tpu/slam/run.py``)."""

from __future__ import annotations

import numpy as np

from ..config import CameraConfig, SLAMConfig
from .pose_graph import close_loops
from .tracker import StereoSLAM, absolute_trajectory_error


def run_odometry_sequence(
    sequence,
    engine=None,
    slam_cfg: SLAMConfig = SLAMConfig(),
    max_frames: int = 0,
    ba_window: int = 4,
    num_keypoints: int = 512,
    loop_closure: bool = False,
    loop_every: int = 10,
    device=None,
) -> dict:
    """Run stereo VO over an odometry sequence (KITTI layout or anything
    exposing __len__/__getitem__ -> OdometryFrame and .camera/.gt_centers).

    ``engine`` supplies network disparity via ``engine.infer``; when None
    the sequence frames must be consumed GT-free (tracker uses network
    only) — for dense-GT synthetic scenes use the tracker directly.
    The tracker runs on ``device`` (default: the engine's, else ``cuda:0``).
    """
    camera: CameraConfig = sequence.camera
    if camera.width == 0 or camera.height == 0 or camera.width == 1280:
        # Fill image geometry from the first frame (calib.txt has no size).
        first = sequence[0]
        camera = CameraConfig(
            focal_px=camera.focal_px,
            baseline_mm=camera.baseline_mm,
            width=first.left.shape[1],
            height=first.left.shape[0],
        )
    if device is None:
        device = getattr(engine, "device", None)
    slam = StereoSLAM(camera, slam_cfg, num_keypoints=num_keypoints, device=device)

    n = len(sequence) if max_frames == 0 else min(max_frames, len(sequence))
    loops = 0
    for i in range(n):
        fr = sequence[i]
        if engine is not None:
            disp = engine.infer(fr.left, fr.right)
        else:
            raise ValueError("run_odometry_sequence needs an engine for disparity")
        slam.process(fr.left, disp)
        if ba_window and len(slam.state.keyframes) >= 2 and (i + 1) % 5 == 0:
            slam.refine_window(window=ba_window)
        if loop_closure and (i + 1) % loop_every == 0:
            if close_loops(slam) is not None:
                loops += 1

    est = np.stack(slam.state.trajectory)
    out = {
        "frames": n,
        "tracked": slam.state.frames_tracked,
        "lost": slam.state.frames_lost,
        "keyframes": len(slam.state.keyframes),
    }
    if loop_closure:
        out["loops_closed"] = loops
    gt = sequence.gt_centers() if hasattr(sequence, "gt_centers") else None
    if gt is not None:
        gt = gt[:n]
        # EuRoC GT can be missing at sequence edges (NaN rows from the
        # nearest-timestamp association) — align on the covered frames only.
        ok = np.isfinite(gt).all(axis=-1)
        if ok.sum() >= 2:
            out["ate_m"] = absolute_trajectory_error(est[ok], gt[ok])
    return out


def open_sequence(root: str, sequence: str = ""):
    """Auto-detect the odometry dataset layout under ``root``: EuRoC ASL
    (``mav0`` directory) vs KITTI odometry (``sequences`` directory)."""
    import os

    from ..data.euroc import EurocSequence
    from ..data.kitti_odometry import KittiOdometrySequence

    base = os.path.join(root, sequence) if sequence else root
    if os.path.isdir(os.path.join(base, "mav0")):
        return EurocSequence(root, sequence)
    if os.path.isdir(os.path.join(root, "mav0")):
        return EurocSequence(root, "")  # root IS the sequence directory
    return KittiOdometrySequence(root, sequence or "00")

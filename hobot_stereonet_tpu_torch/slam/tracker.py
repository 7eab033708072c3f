"""Stereo SLAM front end and windowed back end: the port of
``hobot_stereonet_tpu/slam/tracker.py``.

Per frame (the left image and a dense disparity from the stereo network):

  1. detect and describe Harris/patch features (static K)
  2. triangulate the keypoints with the disparity
  3. match them against the active keyframe
  4. robust PnP -> the camera pose
  5. the keyframe decision (translation, rotation, inlier thresholds)
  6. windowed bundle adjustment over recent keyframes (on request)

Steps 1-4 and 6 run on the tracker's device (``cuda:0`` unless the caller
passes ``device="cpu"``); the map state (keyframe poses, landmarks) is
small and lives in numpy on the host.  Map files (:func:`save_map`) are
the JAX package's ``.npz`` layout, so either package loads the other's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, SLAMConfig, resolve_device
from . import se3
from .ba import BAProblem, bundle_adjust
from .features import Keypoints, detect_and_describe, match
from .odometry import robust_pnp, triangulate


@dataclass
class Keyframe:
    index: int
    R: np.ndarray          # world -> cam
    t: np.ndarray
    keypoints: Keypoints   # on the tracker's device (static K)
    points_w: np.ndarray   # [K, 3] triangulated world points
    valid: np.ndarray      # [K]


@dataclass
class TrackerState:
    keyframes: List[Keyframe] = field(default_factory=list)
    trajectory: List[np.ndarray] = field(default_factory=list)  # camera centers
    poses: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    frames_tracked: int = 0
    frames_lost: int = 0


class StereoSLAM:
    """The tracker.  ``seed`` seeds the ``torch.Generator`` the RANSAC
    draws from (the JAX package's PRNG key)."""

    def __init__(self, camera: CameraConfig, cfg: SLAMConfig = SLAMConfig(),
                 num_keypoints: int = 512, seed: int = 0,
                 device: "str | torch.device | None" = None):
        self.camera = camera
        self.cfg = cfg
        self.k = num_keypoints
        self.device = resolve_device(device, "StereoSLAM")
        self.state = TrackerState()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # Frame indices of keyframes pinned by loop-closure edges
        # (pose_graph.close_loops registers both endpoints): window
        # eviction keeps them.
        self.loop_anchor_indices: set = set()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _make_keyframe(self, index, R, t, kp: Keypoints, disp: torch.Tensor,
                       confidence=None) -> Keyframe:
        d = disp[kp.xy[:, 1].long(), kp.xy[:, 0].long()]
        pts_cam, tri_valid = triangulate(kp.xy, d, self.camera)
        Rinv, tinv = se3.inverse(self._tensor(R), self._tensor(t))
        pts_w = se3.transform(Rinv, tinv, pts_cam)
        valid = kp.valid & tri_valid
        if confidence is not None and self.cfg.min_confidence > 0.0:
            # Map only points whose disparity the network is sure of (the
            # soft-argmin's peak probability at 1/8 resolution).
            conf = self._tensor(confidence)
            sh, sw = disp.shape[0] / conf.shape[0], disp.shape[1] / conf.shape[1]
            cy = torch.clamp((kp.xy[:, 1] / sh).long(), 0, conf.shape[0] - 1)
            cx = torch.clamp((kp.xy[:, 0] / sw).long(), 0, conf.shape[1] - 1)
            valid = valid & (conf[cy, cx] >= self.cfg.min_confidence)
        return Keyframe(index=index, R=np.asarray(R), t=np.asarray(t), keypoints=kp,
                        points_w=pts_w.cpu().numpy(), valid=valid.cpu().numpy())

    def process(self, left_image: np.ndarray, disparity: np.ndarray,
                confidence: Optional[np.ndarray] = None) -> dict:
        """One frame.  Returns {"pose": (R, t), "tracked": bool, ...}.

        ``confidence``: optional [H/8, W/8] peak-probability map (the
        engine's ``infer_with_confidence``); it gates which keypoints become
        landmarks when ``SLAMConfig.min_confidence`` > 0."""
        st = self.state
        with torch.inference_mode():
            img, disp = self._tensor(left_image), self._tensor(disparity)
            kp = detect_and_describe(img, num_keypoints=self.k)
            if not st.keyframes:
                R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
                st.keyframes.append(self._make_keyframe(0, R, t, kp, disp, confidence))
                st.poses.append((R, t))
                st.trajectory.append(self._center(R, t))
                st.frames_tracked += 1
                return {"pose": (R, t), "tracked": True, "keyframe": True,
                        "num_inliers": int(np.sum(st.keyframes[-1].valid))}

            ref = st.keyframes[-1]
            m = match(ref.keypoints, kp)
            mvalid = m.valid & self._tensor(ref.valid)[m.idx_a]
            res = robust_pnp(self.generator, self._tensor(ref.points_w)[m.idx_a],
                             kp.xy[m.idx_b], mvalid, self.camera,
                             thresh_px=self.cfg.huber_delta_px)
            n_inl = int(res.num_inliers)
            if n_inl < 12:
                st.frames_lost += 1
                # Hold the last pose (drop and continue).
                R, t = st.poses[-1]
                st.poses.append((R, t))
                st.trajectory.append(self._center(R, t))
                return {"pose": (R, t), "tracked": False, "keyframe": False,
                        "num_inliers": n_inl}

            R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
            st.poses.append((R, t))
            st.trajectory.append(self._center(R, t))
            st.frames_tracked += 1
            is_kf = self._keyframe_due(ref, R, t, n_inl)
            if is_kf:
                st.keyframes.append(self._make_keyframe(len(st.poses) - 1, R, t, kp, disp,
                                                        confidence))
                if len(st.keyframes) > self.cfg.max_keyframes:
                    # Evict the oldest keyframe that is not a loop anchor
                    # (plain FIFO if every keyframe is one).
                    for k_i, cand in enumerate(st.keyframes):
                        if cand.index not in self.loop_anchor_indices:
                            st.keyframes.pop(k_i)
                            break
                    else:
                        st.keyframes.pop(0)
        return {"pose": (R, t), "tracked": True, "keyframe": is_kf, "num_inliers": n_inl}

    def _center(self, R, t) -> np.ndarray:
        return np.asarray(-R.T @ t)

    def _keyframe_due(self, ref: Keyframe, R, t, n_inliers: int) -> bool:
        dR = torch.as_tensor(ref.R.T @ R)
        rot = float(torch.linalg.vector_norm(se3.log_so3(dR)))
        trans = float(np.linalg.norm(self._center(R, t) - self._center(ref.R, ref.t)))
        return (trans > self.cfg.keyframe_translation_m
                or np.degrees(rot) > self.cfg.keyframe_rotation_deg
                or n_inliers < self.k // 8)

    def refine_window(self, window: int = 0) -> Optional[dict]:
        """Windowed BA over the most recent keyframes: the newest keyframe's
        valid points are the landmarks, observed in each window keyframe by
        descriptor matching."""
        st = self.state
        n = min(window or len(st.keyframes), len(st.keyframes))
        if n < 2:
            return None
        kfs = st.keyframes[-n:]
        newest = kfs[-1]
        m_lm = newest.points_w.shape[0]
        obs = np.zeros((n, m_lm, 2), np.float32)
        valid = np.zeros((n, m_lm), bool)
        obs[-1] = newest.keypoints.xy.cpu().numpy()
        valid[-1] = newest.valid
        with torch.inference_mode():
            for i, kf in enumerate(kfs[:-1]):
                mm = match(newest.keypoints, kf.keypoints)
                idx_b = mm.idx_b.cpu().numpy()
                v = mm.valid.cpu().numpy() & newest.valid & kf.valid[idx_b]
                obs[i][v] = kf.keypoints.xy.cpu().numpy()[idx_b][v]
                valid[i] = v
            # Landmarks seen in fewer than 2 frames are unconstrained (rank-2
            # Hll): mask them out.
            valid &= (valid.sum(axis=0) >= 2)[None, :]
            problem = BAProblem(
                poses=(self._tensor(np.stack([kf.R for kf in kfs])),
                       self._tensor(np.stack([kf.t for kf in kfs]))),
                landmarks=self._tensor(newest.points_w), obs=self._tensor(obs),
                valid=self._tensor(valid))
            res = bundle_adjust(problem, self.camera, iters=self.cfg.ba_iterations,
                                huber_px=self.cfg.huber_delta_px,
                                damping=self.cfg.ba_damping)
            R_all, t_all = res.R.cpu().numpy(), res.t.cpu().numpy()
        # Write back the refined poses and landmarks, the trajectory entries
        # at each keyframe's frame index too.
        for i, kf in enumerate(kfs):
            kf.R, kf.t = R_all[i], t_all[i]
            if 0 <= kf.index < len(st.poses):
                st.poses[kf.index] = (kf.R, kf.t)
                st.trajectory[kf.index] = self._center(kf.R, kf.t)
        newest.points_w = res.landmarks.cpu().numpy()
        return {"cost": res.cost_history.cpu().numpy()}


def absolute_trajectory_error(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """RMS ATE after aligning the trajectories by their centroids and the
    optimal rotation (Kabsch; no scale: stereo gives metric scale)."""
    est = est_centers - est_centers.mean(axis=0, keepdims=True)
    gt = gt_centers - gt_centers.mean(axis=0, keepdims=True)
    U, _, Vt = np.linalg.svd(est.T @ gt)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    Rot = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    aligned = est @ Rot.T
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def save_map(path: str, slam: StereoSLAM) -> None:
    """Snapshot keyframe poses, landmarks, descriptors and the trajectory to
    one ``.npz`` (the JAX package's keys and types)."""
    st = slam.state
    arrays = {
        "trajectory": np.stack(st.trajectory) if st.trajectory else np.zeros((0, 3)),
        "frames_tracked": np.asarray(st.frames_tracked),
        "frames_lost": np.asarray(st.frames_lost),
        "num_keyframes": np.asarray(len(st.keyframes)),
    }
    for i, kf in enumerate(st.keyframes):
        kp = kf.keypoints
        arrays.update({
            f"kf{i}_index": np.asarray(kf.index), f"kf{i}_R": kf.R, f"kf{i}_t": kf.t,
            f"kf{i}_points": kf.points_w, f"kf{i}_valid": kf.valid,
            f"kf{i}_xy": kp.xy.cpu().numpy(), f"kf{i}_score": kp.score.cpu().numpy(),
            f"kf{i}_desc": kp.desc.cpu().numpy(), f"kf{i}_kpvalid": kp.valid.cpu().numpy(),
        })
    np.savez_compressed(path, **arrays)


def load_map(path: str, slam: StereoSLAM) -> StereoSLAM:
    """Restore a saved map into ``slam`` (in place; returns it)."""
    data = np.load(path)
    st = slam.state
    traj = data["trajectory"]
    st.trajectory = [traj[i] for i in range(traj.shape[0])]
    st.poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))] * len(st.trajectory)
    st.frames_tracked = int(data["frames_tracked"])
    st.frames_lost = int(data["frames_lost"])
    st.keyframes = []
    for i in range(int(data["num_keyframes"])):
        kp = Keypoints(*(slam._tensor(data[f"kf{i}_{k}"])
                         for k in ("xy", "score", "desc", "kpvalid")))
        st.keyframes.append(Keyframe(
            index=int(data[f"kf{i}_index"]), R=data[f"kf{i}_R"], t=data[f"kf{i}_t"],
            keypoints=kp, points_w=data[f"kf{i}_points"], valid=data[f"kf{i}_valid"]))
    return slam

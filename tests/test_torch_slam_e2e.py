"""End-to-end stereo SLAM of the port against the JAX package's, on the CPU.

The JAX package's own end-to-end run (``tests/test_slam_e2e.py``): a
``LayeredScene`` from seed 11 at 320x240, 12 frames of a 1.2 m sideways
and vertical trajectory, 256 keypoints, ground-truth disparity.  The port
must never lose track, keep the JAX bound on the ATE (0.05 m) and come
within 0.01 m of the JAX package's own ATE on the same frames (the
trackers' RANSAC draws differ: a torch generator against a JAX key).
Map files pass between the packages both ways.
"""

import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import CameraConfig as JCameraConfig
from hobot_stereonet_tpu.config import SLAMConfig as JSLAMConfig
from hobot_stereonet_tpu.data.synthetic import LayeredScene
from hobot_stereonet_tpu.slam import tracker as jtracker
from hobot_stereonet_tpu_torch.config import CameraConfig, SLAMConfig
from hobot_stereonet_tpu_torch.slam import tracker as ttracker

torch.set_num_threads(1)

JCAM = JCameraConfig(width=320, height=240, focal_px=300.0, baseline_mm=120.0)
CAM = CameraConfig(width=320, height=240, focal_px=300.0, baseline_mm=120.0)
ATE_BOUND = 0.05
ATE_TO_JAX = 0.01


@pytest.fixture(scope="module")
def frames():
    scene = LayeredScene(np.random.default_rng(11), CAM.height, CAM.width, CAM.focal_px,
                         CAM.baseline_m)
    ts = np.linspace(0, 1, 12)
    gt = np.stack([0.6 * ts, 0.12 * np.sin(2 * np.pi * ts), np.zeros_like(ts)], axis=-1)
    return gt, [scene.render(float(x), float(y)) for x, y, _ in gt], scene


def _run(slam, rendered):
    return [slam.process(l, d) for l, _, d in rendered]


@pytest.fixture(scope="module")
def runs(frames):
    gt, rendered, _ = frames
    port = ttracker.StereoSLAM(CAM, SLAMConfig(keyframe_translation_m=0.08, ba_iterations=6),
                               num_keypoints=256, device="cpu")
    jax_slam = jtracker.StereoSLAM(
        JCAM, JSLAMConfig(keyframe_translation_m=0.08, ba_iterations=6), num_keypoints=256)
    return (port, _run(port, rendered)), (jax_slam, _run(jax_slam, rendered))


def _ate(slam, gt):
    return ttracker.absolute_trajectory_error(np.stack(slam.state.trajectory), gt)


def test_port_never_loses_track(runs):
    (slam, results), _ = runs
    assert all(r["tracked"] for r in results)
    assert slam.state.frames_lost == 0
    assert np.median([r["num_inliers"] for r in results[1:]]) > 40


def test_ate_within_bound_and_near_jax(runs, frames):
    gt = frames[0]
    (slam, _), (jslam, _) = runs
    ate, jate = _ate(slam, gt), _ate(jslam, gt)
    assert ate < ATE_BOUND, f"ATE {ate:.4f} m"
    assert abs(ate - jate) < ATE_TO_JAX, (ate, jate)
    assert len(slam.state.keyframes) >= 3
    assert abs(len(slam.state.keyframes) - len(jslam.state.keyframes)) <= 1


def test_windowed_ba_does_not_raise_cost(frames):
    gt, rendered, _ = frames
    slam = ttracker.StereoSLAM(CAM, SLAMConfig(keyframe_translation_m=0.08, ba_iterations=6),
                               num_keypoints=256, device="cpu")
    _run(slam, rendered)
    out = slam.refine_window(window=3)
    costs = out["cost"]
    assert costs[-1] <= costs[0] * 1.01
    for kf in slam.state.keyframes:
        assert np.all(np.isfinite(kf.R)) and np.all(np.isfinite(kf.t))
    assert _ate(slam, gt) < ATE_BOUND


def test_ate_metric_matches_jax():
    rng = np.random.default_rng(0)
    est, gt = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    assert ttracker.absolute_trajectory_error(est, gt) == \
        jtracker.absolute_trajectory_error(est, gt)


def _next_frame(scene):
    return scene.render(0.62, 0.0)


def test_map_files_pass_between_packages(runs, frames, tmp_path):
    (slam, _), (jslam, _) = runs
    _, _, scene = frames
    l, _, d = _next_frame(scene)
    # The port's map -> the JAX package, which keeps tracking against it.
    ttracker.save_map(str(tmp_path / "port.npz"), slam)
    jloaded = jtracker.load_map(str(tmp_path / "port.npz"),
                                jtracker.StereoSLAM(JCAM, JSLAMConfig(), num_keypoints=256))
    assert len(jloaded.state.keyframes) == len(slam.state.keyframes)
    for kf, jkf in zip(slam.state.keyframes, jloaded.state.keyframes):
        assert kf.index == jkf.index
        np.testing.assert_array_equal(kf.R, jkf.R)
        np.testing.assert_array_equal(kf.points_w, jkf.points_w)
        np.testing.assert_array_equal(kf.keypoints.desc.numpy(), np.asarray(jkf.keypoints.desc))
    np.testing.assert_array_equal(np.stack(jloaded.state.trajectory),
                                  np.stack(slam.state.trajectory))
    assert jloaded.process(l, d)["tracked"]
    # The JAX package's map -> the port, which keeps tracking against it.
    jtracker.save_map(str(tmp_path / "jax.npz"), jslam)
    loaded = ttracker.load_map(str(tmp_path / "jax.npz"),
                               ttracker.StereoSLAM(CAM, SLAMConfig(), num_keypoints=256,
                                                   device="cpu"))
    assert len(loaded.state.keyframes) == len(jslam.state.keyframes)
    for kf, jkf in zip(loaded.state.keyframes, jslam.state.keyframes):
        np.testing.assert_array_equal(kf.t, jkf.t)
        np.testing.assert_array_equal(kf.valid, jkf.valid)
        np.testing.assert_array_equal(kf.keypoints.xy.numpy(), np.asarray(jkf.keypoints.xy))
    assert (loaded.state.frames_tracked, loaded.state.frames_lost) == (
        jslam.state.frames_tracked, jslam.state.frames_lost)
    assert loaded.process(l, d)["tracked"]
    # And back: the port writes what it read.
    ttracker.save_map(str(tmp_path / "again.npz"), loaded)
    a, b = np.load(str(tmp_path / "jax.npz")), np.load(str(tmp_path / "again.npz"))
    assert set(a.files) <= set(b.files)


def test_confidence_gate_matches_jax():
    """The gate maps only keypoints in confident cells, as the JAX
    package's does: the same landmark counts, ungated, half-gated and
    fully confident."""
    scene = LayeredScene(np.random.default_rng(7), CAM.height, CAM.width, CAM.focal_px,
                         CAM.baseline_m)
    l, _, d = scene.render(0.0, 0.0)
    conf = np.zeros((CAM.height // 8, CAM.width // 8), np.float32)
    conf[:, : conf.shape[1] // 2] = 1.0
    counts = []
    for gate, c in ((0.0, None), (0.5, conf), (0.5, np.ones_like(conf))):
        port = ttracker.StereoSLAM(CAM, SLAMConfig(min_confidence=gate), device="cpu")
        jax_slam = jtracker.StereoSLAM(JCAM, JSLAMConfig(min_confidence=gate))
        n = port.process(l, d, confidence=c)["num_inliers"]
        assert n == jax_slam.process(l, d, confidence=c)["num_inliers"]
        np.testing.assert_array_equal(port.state.keyframes[0].valid,
                                      jax_slam.state.keyframes[0].valid)
        counts.append(n)
    assert 0 < counts[1] < counts[0] == counts[2]

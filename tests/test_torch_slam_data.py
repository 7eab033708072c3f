"""The port's odometry readers (EuRoC, KITTI odometry), ``open_sequence``
and ``run_odometry_sequence`` against the JAX package's, on the CPU.

The fixtures are written under ``tmp_path`` as ``tests/test_euroc.py``
writes them (a synthesized tree, no real dataset).  The readers are numpy
in both packages and must agree exactly; the sequence runner drives each
package's tracker on a rendered trajectory with a stub engine that returns
the ground-truth disparity, and must agree on the counts and to 0.01 m on
the ATE (tests/test_torch_slam_e2e.py's bound).
"""

import os

import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.data import euroc as jeuroc
from hobot_stereonet_tpu.data import kitti_odometry as jkitti
from hobot_stereonet_tpu.data.synthetic import LayeredScene
from hobot_stereonet_tpu.slam import run as jrun
from hobot_stereonet_tpu_torch.data import euroc as teuroc
from hobot_stereonet_tpu_torch.data import kitti_odometry as tkitti
from hobot_stereonet_tpu_torch.slam import run as trun
from tests.test_euroc import _cam, _roty, _rotz, _write_sensor_yaml

torch.set_num_threads(1)

H, W, FOCAL, BASELINE = 240, 320, 300.0, 0.12
N_FRAMES = 10


def _trajectory():
    ts = np.linspace(0, 1, N_FRAMES)
    return np.stack([0.6 * ts, 0.12 * np.sin(2 * np.pi * ts), np.zeros_like(ts)], axis=-1)


@pytest.fixture(scope="module")
def rendered():
    scene = LayeredScene(np.random.default_rng(11), H, W, FOCAL, BASELINE)
    centers = _trajectory()
    return centers, [scene.render(float(x), float(y)) for x, y, _ in centers]


@pytest.fixture(scope="module")
def euroc_root(rendered, tmp_path_factory):
    centers, frames = rendered
    root = tmp_path_factory.mktemp("euroc")
    teuroc.write_sequence(str(root / "MH_01_easy"), [f[0] for f in frames],
                          [f[1] for f in frames], centers, FOCAL, BASELINE)
    return str(root)


def test_rectification_matches_jax():
    t1 = np.eye(4)
    t1[:3, :3] = _roty(0.03) @ _rotz(0.01)
    t1[:3, 3] = [0.11, 0.002, -0.001]
    dist = (-0.28, 0.07, 0.00019, 1.76e-05)
    cams = [(_cam(np.eye(4), [100.0, 100.0, 31.5, 23.5], dist=dist),
             _cam(t1, [102.0, 101.0, 30.0, 24.0], dist=dist))]
    tcams = [tuple(teuroc.EurocCamera(c.T_BS, c.intrinsics, c.distortion, c.resolution)
                   for c in pair) for pair in cams]
    for (c0, c1), (d0, d1) in zip(cams, tcams):
        want = jeuroc.stereo_rectify(c0, c1)
        got = teuroc.stereo_rectify(d0, d1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for cam, tcam, r in ((c0, d0, want[0]), (c1, d1, want[1])):
            for a, b in zip(teuroc.rectify_map(tcam, r, want[2]),
                            jeuroc.rectify_map(cam, r, want[2])):
                np.testing.assert_array_equal(a, b)
        mx, my = jeuroc.rectify_map(c0, want[0], want[2])
        img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
        np.testing.assert_array_equal(teuroc.remap_bilinear(img, mx, my),
                                      jeuroc.remap_bilinear(img, mx, my))


def test_sensor_yaml_matches_jax(tmp_path):
    t_bs = np.eye(4)
    t_bs[:3, 3] = [0.01, -0.02, 0.03]
    path = str(tmp_path / "sensor.yaml")
    _write_sensor_yaml(path, t_bs, [458.654, 457.296, 367.215, 248.375], (752, 480),
                       [-0.28, 0.07, 0.00019, 1.76e-05])
    got, want = teuroc.read_sensor_yaml(path), jeuroc.read_sensor_yaml(path)
    for f in ("T_BS", "intrinsics", "distortion"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.resolution == want.resolution


def test_written_euroc_sequence_reads_as_in_jax(euroc_root, rendered):
    centers, frames = rendered
    seq = teuroc.EurocSequence(euroc_root, "MH_01_easy")
    jseq = jeuroc.EurocSequence(euroc_root, "MH_01_easy")
    assert len(seq) == len(jseq) == N_FRAMES
    assert (seq.camera.focal_px, seq.camera.baseline_mm, seq.camera.width,
            seq.camera.height) == (jseq.camera.focal_px, jseq.camera.baseline_mm,
                                   jseq.camera.width, jseq.camera.height)
    np.testing.assert_array_equal(seq.gt_centers(), jseq.gt_centers())
    np.testing.assert_allclose(seq.gt_centers(), centers, atol=1e-6)
    for i in (0, N_FRAMES - 1):
        fr, jfr = seq[i], jseq[i]
        np.testing.assert_array_equal(fr.left, jfr.left)
        np.testing.assert_array_equal(fr.right, jfr.right)
        np.testing.assert_array_equal(fr.gt_pose, jfr.gt_pose)
        # An ideal rig: rectifying is the identity.
        np.testing.assert_array_equal(fr.left, frames[i][0])


def _write_kitti(root, frames, centers):
    from PIL import Image

    seq_dir = os.path.join(root, "sequences", "00")
    for side in ("image_2", "image_3"):
        os.makedirs(os.path.join(seq_dir, side), exist_ok=True)
    for i, (l, r, _) in enumerate(frames[:3]):
        Image.fromarray(l).save(os.path.join(seq_dir, "image_2", f"{i:06d}.png"))
        Image.fromarray(r).save(os.path.join(seq_dir, "image_3", f"{i:06d}.png"))
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(f"P2: {FOCAL} 0 {W / 2} 0 0 {FOCAL} {H / 2} 0 0 0 1 0\n")
        f.write(f"P3: {FOCAL} 0 {W / 2} {-FOCAL * BASELINE} 0 {FOCAL} {H / 2} 0 0 0 1 0\n")
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        for c in centers[:3]:
            f.write(" ".join(map(str, [1, 0, 0, c[0], 0, 1, 0, c[1], 0, 0, 1, c[2]])) + "\n")


def test_kitti_odometry_reads_as_in_jax(rendered, tmp_path):
    centers, frames = rendered
    _write_kitti(str(tmp_path), frames, centers)
    seq = tkitti.KittiOdometrySequence(str(tmp_path), "00")
    jseq = jkitti.KittiOdometrySequence(str(tmp_path), "00")
    assert len(seq) == len(jseq) == 3
    assert (seq.camera.focal_px, seq.camera.baseline_mm) == (jseq.camera.focal_px,
                                                             jseq.camera.baseline_mm)
    assert abs(seq.camera.baseline_m - BASELINE) < 1e-9
    np.testing.assert_array_equal(seq.gt_centers(), jseq.gt_centers())
    fr, jfr = seq[1], jseq[1]
    np.testing.assert_array_equal(fr.left, jfr.left)
    np.testing.assert_array_equal(fr.right, jfr.right)
    np.testing.assert_array_equal(fr.gt_pose, jfr.gt_pose)


def test_open_sequence_detects_both_layouts(euroc_root, rendered, tmp_path):
    centers, frames = rendered
    assert isinstance(trun.open_sequence(euroc_root, "MH_01_easy"), teuroc.EurocSequence)
    assert isinstance(trun.open_sequence(os.path.join(euroc_root, "MH_01_easy")),
                      teuroc.EurocSequence)
    _write_kitti(str(tmp_path), frames, centers)
    assert isinstance(trun.open_sequence(str(tmp_path), "00"), tkitti.KittiOdometrySequence)
    assert isinstance(jrun.open_sequence(str(tmp_path), "00"), jkitti.KittiOdometrySequence)


class _GTEngine:
    """Stub engine: ``infer`` returns the ground-truth disparity of the
    rendered frame it is given."""

    def __init__(self, frames, device=None):
        self._disp = {l.tobytes(): d for l, _, d in frames}
        self.device = device

    def infer(self, left, right):
        return self._disp[np.ascontiguousarray(left).tobytes()]


@pytest.mark.parametrize("loop_closure", [False, True])
def test_run_odometry_sequence_matches_jax(euroc_root, rendered, loop_closure):
    _, frames = rendered
    kw = dict(max_frames=0, loop_closure=loop_closure, loop_every=5)
    got = trun.run_odometry_sequence(teuroc.EurocSequence(euroc_root, "MH_01_easy"),
                                     engine=_GTEngine(frames, "cpu"), **kw)
    want = jrun.run_odometry_sequence(jeuroc.EurocSequence(euroc_root, "MH_01_easy"),
                                      engine=_GTEngine(frames), **kw)
    assert set(got) == set(want)
    for k in ("frames", "tracked", "lost", "keyframes", "loops_closed"):
        assert got.get(k) == want.get(k), k
    assert got["lost"] == 0 and got["ate_m"] < 0.05
    assert abs(got["ate_m"] - want["ate_m"]) < 0.01

"""The port's SLAM geometry against the JAX package's, on the CPU.

The inputs are the JAX tests' own problems (``tests/test_slam_geometry.py``,
``test_ba.py``, ``test_pose_graph.py``) from the same seeds.  Bounds, all
float32: 1e-5 for the se3 maps, triangulation and projection (a few ulps of
values of order 1-10); 1e-4 for optimized poses (Gauss-Newton and the
Schur solve through LAPACK in another summation order); landmarks after
BA 1e-3 m (their blocks are the least constrained, as the JAX package's
distributed test notes).  The Harris response equals the JAX package's
eager one bit for bit (the same float32 operations in the same order);
inside ``detect_and_describe``, which JAX compiles, XLA fuses some of its
multiplies and adds, so the keypoints' scores differ by up to 2e-6
relative (held at 1e-5) while the keypoints, their validity and the
matches are the same.  Descriptors are held at 1e-6 (the mean and the norm
sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import CameraConfig as JCameraConfig
from hobot_stereonet_tpu.slam import features as jf
from hobot_stereonet_tpu.slam import odometry as jo
from hobot_stereonet_tpu.slam import se3 as jse3
from hobot_stereonet_tpu.slam.ba import bundle_adjust as jbundle_adjust
from hobot_stereonet_tpu.slam.pose_graph import _pair_similarity
from hobot_stereonet_tpu.slam.pose_graph import optimize_pose_graph as joptimize
from hobot_stereonet_tpu_torch.config import CameraConfig
from hobot_stereonet_tpu_torch.slam import features as tf
from hobot_stereonet_tpu_torch.slam import odometry as to
from hobot_stereonet_tpu_torch.slam import se3 as tse3
from hobot_stereonet_tpu_torch.slam.ba import BAProblem, bundle_adjust
from hobot_stereonet_tpu_torch.slam.pose_graph import (
    PoseGraph, optimize_pose_graph, similarity_scores)
from tests.test_ba import _make_problem
from tests.test_pose_graph import _drift_problem
from tests.test_slam_geometry import _checkerboard, _synthetic_pnp_problem

torch.set_num_threads(1)

JCAM = JCameraConfig(width=640, height=480, focal_px=500.0, baseline_mm=120.0)
CAM = CameraConfig(width=640, height=480, focal_px=500.0, baseline_mm=120.0)
SE3_ATOL = 1e-5
POSE_ATOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))     # a writable copy


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def test_se3_maps_match_jax():
    rng = np.random.default_rng(1234)
    phi = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    xi = rng.uniform(-1, 1, (8, 6)).astype(np.float32)
    small = np.array([[1e-7, -2e-7, 5e-8], [0.0, 0.0, 0.0]], np.float32)
    _close(tse3.hat(_t(phi)), jse3.hat(jnp.asarray(phi)), 0)
    for p in (phi, small):
        R = tse3.exp_so3(_t(p))
        _close(R, jse3.exp_so3(jnp.asarray(p)), SE3_ATOL)
        _close(tse3.log_so3(R), jse3.log_so3(jnp.asarray(R.numpy())), SE3_ATOL)
    R, t = tse3.exp_se3(_t(xi))
    jR, jt = jse3.exp_se3(jnp.asarray(xi))
    _close(R, jR, SE3_ATOL)
    _close(t, jt, SE3_ATOL)
    _close(tse3.log_se3(R, t), jse3.log_se3(jnp.asarray(R.numpy()), jnp.asarray(t.numpy())),
           SE3_ATOL)
    Ri, ti = tse3.inverse(R, t)
    jRi, jti = jse3.inverse(jR, jt)
    _close(Ri, jRi, SE3_ATOL)
    _close(ti, jti, SE3_ATOL)
    Rc, tc = tse3.compose(R, t, Ri.flip(0), ti.flip(0))
    jRc, jtc = jse3.compose(jR, jt, jRi[::-1], jti[::-1])
    _close(Rc, jRc, SE3_ATOL)
    _close(tc, jtc, SE3_ATOL)
    pts = rng.standard_normal((8, 5, 3)).astype(np.float32)
    _close(tse3.transform(R, t, _t(pts)), jse3.transform(jR, jt, jnp.asarray(pts)), SE3_ATOL)
    rot, tr = tse3.relative_pose_error(R, t, Ri, ti)
    jrot, jtr = jse3.relative_pose_error(jR, jt, jRi, jti)
    _close(rot, jrot, SE3_ATOL)
    _close(tr, jtr, SE3_ATOL)
    Ri0, ti0 = tse3.identity((2,))
    _close(Ri0, jse3.identity((2,))[0], 0)
    _close(ti0, jse3.identity((2,))[1], 0)


def test_geometry_entry_points_run_without_tf32(monkeypatch):
    """Every geometry entry point enters float32_exact (TF32 off)."""
    from hobot_stereonet_tpu_torch.utils import precision

    seen = []
    real = precision.float32_exact

    def spy():
        seen.append(1)
        return real()

    monkeypatch.setattr(tse3, "float32_exact", spy)
    xi = torch.zeros(6)
    for fn, args in ((tse3.exp_se3, (xi,)), (tse3.log_so3, (torch.eye(3),)),
                     (tse3.compose, (torch.eye(3), xi[:3], torch.eye(3), xi[:3]))):
        seen.clear()
        fn(*args)
        assert seen, fn.__name__
    for fn in (to.pnp_gauss_newton, to.score_hypotheses, bundle_adjust, optimize_pose_graph,
               tf.match, similarity_scores):
        assert getattr(fn, "__wrapped__", None) is not None, fn.__name__


def test_triangulate_and_project_match_jax():
    rng = np.random.default_rng(1234)
    xy = rng.uniform(50, 400, (32, 2)).astype(np.float32)
    disp = rng.uniform(0.2, 60, (32,)).astype(np.float32)
    pts, valid = to.triangulate(_t(xy), _t(disp), CAM)
    jpts, jvalid = jo.triangulate(jnp.asarray(xy), jnp.asarray(disp), JCAM)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=SE3_ATOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    back, front = to.project(pts, CAM)
    jback, jfront = jo.project(jpts, JCAM)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=SE3_ATOL, atol=SE3_ATOL)
    np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
    r2 = _t(rng.uniform(0, 30, 64).astype(np.float32))
    _close(to._huber_weight(r2, 3.0), jo._huber_weight(jnp.asarray(r2.numpy()), 3.0), 1e-7)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------


def test_pnp_gauss_newton_matches_jax():
    jpts, jobs, R_gt, t_gt = _synthetic_pnp_problem(np.random.default_rng(1234), noise=0.3)
    w = np.random.default_rng(2).uniform(0.5, 1.0, jpts.shape[0]).astype(np.float32)
    jR, jt = jo.pnp_gauss_newton(jpts, jobs, jnp.asarray(w), JCAM, *jse3.identity(), iters=10)
    R, t = to.pnp_gauss_newton(_t(jpts), _t(jobs), _t(w), CAM, *tse3.identity(), iters=10)
    _close(R, jR, POSE_ATOL)
    _close(t, jt, POSE_ATOL)


def test_pnp_batches_hypotheses_as_one_solve():
    """A batch of weightings gives each one's own unbatched solve."""
    jpts, jobs, _, _ = _synthetic_pnp_problem(np.random.default_rng(1234))
    pts, obs = _t(jpts), _t(jobs)
    w = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (4, pts.shape[0]))
                         .astype(np.float32))
    Rb, tb = to.pnp_gauss_newton(pts, obs, w, CAM, *tse3.identity((4,)), iters=6)
    for i in range(4):
        R, t = to.pnp_gauss_newton(pts, obs, w[i], CAM, *tse3.identity(), iters=6)
        _close(Rb[i], R, 1e-6)
        _close(tb[i], t, 1e-6)


def _jax_hypotheses(key, valid, num_hypotheses=64, sample_size=6):
    """The indices ``robust_pnp`` of the JAX package draws from ``key``."""
    k = valid.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, num_hypotheses)
    return np.asarray(jax.vmap(
        lambda hk: jax.random.choice(hk, k, shape=(sample_size,), p=p, replace=False))(keys))


def _jax_scores(idx, pts, obs, valid):
    def hypothesis(i):
        w = jnp.zeros((pts.shape[0],)).at[i].set(1.0)
        R, t = jo.pnp_gauss_newton(pts, obs, w, JCAM, *jse3.identity(), iters=6)
        return jnp.sum(jo.reprojection_inliers(R, t, pts, obs, JCAM) & valid)
    return np.asarray(jax.vmap(hypothesis)(jnp.asarray(idx)))


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_robust_pnp_with_jax_samples_picks_jax_hypothesis(outlier_frac):
    jpts, jobs, R_gt, t_gt = _synthetic_pnp_problem(
        np.random.default_rng(1234), noise=0.3, outlier_frac=outlier_frac)
    valid = np.ones(jpts.shape[0], bool)
    valid[::17] = False
    key = jax.random.PRNGKey(0)
    idx = _jax_hypotheses(key, jnp.asarray(valid))
    want = jo.robust_pnp(key, jpts, jobs, jnp.asarray(valid), JCAM)
    jbest = int(np.argmax(_jax_scores(idx, jpts, jobs, jnp.asarray(valid))))
    got = to.score_hypotheses(_t(idx).long(), _t(jpts), _t(jobs), _t(valid), CAM)
    assert int(got.hypothesis) == jbest
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    _close(got.R, want.R, POSE_ATOL)
    _close(got.t, want.t, POSE_ATOL)


def test_sample_hypotheses_draws_distinct_valid_indices():
    valid = torch.zeros(100, dtype=torch.bool)
    valid[10:40] = True
    idx = to.sample_hypotheses(torch.Generator().manual_seed(0), valid, 64, 6)
    again = to.sample_hypotheses(torch.Generator().manual_seed(0), valid, 64, 6)
    assert idx.shape == (64, 6) and torch.equal(idx, again)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 6 for row in idx)
    # The draws spread over every valid index.
    assert set(idx.flatten().tolist()) == set(range(10, 40))


def test_robust_pnp_rejects_outliers():
    jpts, jobs, R_gt, t_gt = _synthetic_pnp_problem(np.random.default_rng(1234), noise=0.3,
                                                    outlier_frac=0.3)
    n = jpts.shape[0]
    res = to.robust_pnp(torch.Generator().manual_seed(0), _t(jpts), _t(jobs),
                        torch.ones(n, dtype=torch.bool), CAM)
    rot, tr = tse3.relative_pose_error(res.R, res.t, _t(R_gt), _t(t_gt))
    assert float(rot) < 0.01 and float(tr) < 0.02
    assert int(res.num_inliers) > 0.5 * n
    assert not bool(res.inliers[: int(0.3 * n)][:5].any())


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def _textured(seed=3, h=96, w=128):
    from hobot_stereonet_tpu.data.synthetic import _texture

    r3 = np.random.default_rng(seed)
    sm = _texture(r3, h, w, (8, 16, 32))[..., 0]
    return np.clip(sm + r3.uniform(-20, 20, sm.shape), 0, 255)


def _rgb_scene():
    from hobot_stereonet_tpu.data.synthetic import LayeredScene

    scene = LayeredScene(np.random.default_rng(11), 240, 320, 300.0, 0.12)
    return scene.render(0.0, 0.0)[0], scene.render(0.05, 0.01)[0]


@pytest.mark.parametrize("image", ["checkerboard", "textured", "rgb_scene"])
def test_features_match_jax(image):
    if image == "checkerboard":
        a = _checkerboard(128, 192)
        b = np.roll(a, 3, axis=1)
        k = 64
    elif image == "textured":
        a = _textured()
        b = np.roll(a, 4, axis=1)
        k = 128
    else:
        a, b = _rgb_scene()
        k = 256
    g = (np.asarray(jf._gray(jnp.asarray(a))) / 255.0).astype(np.float32)
    resp = tf.harris_response(_t(g))
    jresp = jf.harris_response(jnp.asarray(g))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jresp))
    np.testing.assert_array_equal(tf._nms3(_t(np.asarray(jresp))).numpy(),
                                  np.asarray(jf._nms3(jresp)))
    kps = [tf.detect_and_describe(_t(x), num_keypoints=k) for x in (a, b)]
    jkps = [jf.detect_and_describe(jnp.asarray(x), num_keypoints=k) for x in (a, b)]
    for kp, jkp in zip(kps, jkps):
        np.testing.assert_array_equal(kp.xy.numpy(), np.asarray(jkp.xy))
        np.testing.assert_array_equal(kp.valid.numpy(), np.asarray(jkp.valid))
        np.testing.assert_allclose(kp.score.numpy(), np.asarray(jkp.score), rtol=1e-5)
        _close(kp.desc, jkp.desc, 1e-6)
    m, jm = tf.match(*kps), jf.match(*jkps)
    np.testing.assert_array_equal(m.idx_b.numpy(), np.asarray(jm.idx_b))
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(jm.valid))
    # Place recognition scores over a stack (the loop detector's one pass).
    desc = torch.stack([kps[1].desc, kps[0].desc])
    val = torch.stack([kps[1].valid, kps[0].valid])
    got = similarity_scores(kps[0].desc, kps[0].valid, desc, val)
    want = [float(_pair_similarity(jkps[0].desc, jkps[0].valid, jk.desc, jk.valid))
            for jk in (jkps[1], jkps[0])]
    _close(got, want, 1e-7)


# ---------------------------------------------------------------------------
# Bundle adjustment and the pose graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("px_noise", [0.0, 0.5])
def test_bundle_adjust_matches_jax(px_noise):
    jproblem, (R_gt, t_gt), lm_gt = _make_problem(np.random.default_rng(1234),
                                                  px_noise=px_noise)
    want = jbundle_adjust(jproblem, JCAM, iters=12)
    problem = BAProblem(poses=tuple(_t(p) for p in jproblem.poses),
                        landmarks=_t(jproblem.landmarks), obs=_t(jproblem.obs),
                        valid=_t(jproblem.valid))
    got = bundle_adjust(problem, CAM, iters=12)
    _close(got.R, want.R, POSE_ATOL)
    _close(got.t, want.t, POSE_ATOL)
    _close(got.landmarks, want.landmarks, 1e-3)
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(want.cost_history),
                               rtol=1e-3, atol=1e-3)
    costs = got.cost_history.numpy()
    assert costs[-1] < costs[0]
    _close(got.R[0], problem.poses[0][0], POSE_ATOL)          # pose 0 is the gauge


@pytest.mark.parametrize("odo_noise,pad_to", [(0.0, 0), (0.02, 0), (0.02, 16)])
def test_pose_graph_matches_jax(odo_noise, pad_to):
    jgraph, (R_gt, t_gt) = _drift_problem(np.random.default_rng(1234), odo_noise=odo_noise,
                                          pad_to=pad_to)
    want = joptimize(jgraph, iters=10)
    graph = PoseGraph(*(_t(a) for a in jgraph))
    got = optimize_pose_graph(graph, iters=10)
    _close(got.R, want.R, POSE_ATOL)
    _close(got.t, want.t, POSE_ATOL)
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(want.cost_history),
                               rtol=1e-3, atol=1e-6)

"""The landmark-sharded BA and the edge-sharded pose graph over gloo ranks.

Four rank processes (``tests/torch_mesh_workers.py``, scenario ``slam``,
data = 4) run ``make_distributed_bundle_adjust`` and
``make_distributed_pose_graph`` on the JAX tests' problems
(``tests/test_ba.py``: 4 poses, 64 landmarks; ``tests/test_pose_graph.py``:
12 poses, edges padded to 16).  They are held to the single-device port and
to the JAX package's distributed versions on its 8 virtual devices, at the
JAX tests' tolerances (``tests/test_ba.py:93-120``: poses 1e-4, landmarks
1e-2 relative and absolute; ``tests/test_pose_graph.py:116-128``: 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import MeshConfig as JMeshConfig
from hobot_stereonet_tpu.parallel import mesh as jmesh
from hobot_stereonet_tpu.slam import se3 as jse3
from hobot_stereonet_tpu.slam.ba import make_distributed_bundle_adjust as jdist_ba
from hobot_stereonet_tpu.slam.pose_graph import make_distributed_pose_graph as jdist_pg
from hobot_stereonet_tpu_torch.config import CameraConfig
from hobot_stereonet_tpu_torch.slam.ba import BAProblem, bundle_adjust
from hobot_stereonet_tpu_torch.slam.pose_graph import PoseGraph, optimize_pose_graph
from tests.test_ba import CAM as JCAM
from tests.test_ba import _make_problem
from tests.test_pose_graph import _drift_problem
from tests.torch_mesh_workers import spawn

torch.set_num_threads(1)

CAM = dict(width=640, height=480, focal_px=500.0, baseline_mm=120.0)
BA_ITERS, PG_ITERS = 8, 10
POSE_ATOL = 1e-4
LM_TOL = 1e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problems():
    jba, (R_gt, t_gt), lm_gt = _make_problem(np.random.default_rng(1234), n_landmarks=64)
    jpg, _ = _drift_problem(np.random.default_rng(1234), odo_noise=0.02, pad_to=16)
    return jba, (R_gt, t_gt), jpg


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    jba, _, jpg = problems
    tmp = tmp_path_factory.mktemp("slam")
    torch.save({"camera": CAM, "ba_iters": BA_ITERS, "pg_iters": PG_ITERS,
                "ba": dict(poses=tuple(_t(p) for p in jba.poses), landmarks=_t(jba.landmarks),
                           obs=_t(jba.obs), valid=_t(jba.valid)),
                "pose_graph": {k: _t(v) for k, v in jpg._asdict().items()}},
               tmp / "problems.pt")
    return spawn("slam", 4, tmp, problems=str(tmp / "problems.pt"))


def _port_ba(jba):
    return bundle_adjust(BAProblem(poses=tuple(_t(p) for p in jba.poses),
                                   landmarks=_t(jba.landmarks), obs=_t(jba.obs),
                                   valid=_t(jba.valid)), CameraConfig(**CAM), iters=BA_ITERS)


def _close_ba(got: dict, want) -> None:
    np.testing.assert_allclose(np.asarray(got["R"]), np.asarray(want.R), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(np.asarray(got["t"]), np.asarray(want.t), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(np.asarray(got["landmarks"]), np.asarray(want.landmarks),
                               rtol=LM_TOL, atol=LM_TOL)


def test_distributed_ba_matches_single_device_port(problems, ranks):
    jba, (R_gt, t_gt), _ = problems
    want = _port_ba(jba)
    for res in ranks:                               # every rank holds the same result
        _close_ba(res["ba"], want)
        np.testing.assert_allclose(res["ba"]["cost_history"].numpy(),
                                   want.cost_history.numpy(), rtol=1e-3, atol=1e-3)
    rot_err, _ = jse3.relative_pose_error(jnp.asarray(ranks[0]["ba"]["R"].numpy()),
                                          jnp.asarray(ranks[0]["ba"]["t"].numpy()), R_gt, t_gt)
    assert float(jnp.max(rot_err)) < 1e-3            # and it solves the problem


def test_distributed_ba_matches_jax_distributed(eight_devices, problems, ranks):
    jba = problems[0]
    want = jdist_ba(jmesh.make_mesh(JMeshConfig(data=8, tile=1)), JCAM, iters=BA_ITERS)(jba)
    _close_ba(ranks[0]["ba"], want)


def test_distributed_ba_refuses_uneven_landmarks(ranks):
    assert ranks[0]["ba_uneven"] == "63 landmarks do not split over data=4"


def test_distributed_pose_graph_matches_single_device_port(problems, ranks):
    want = optimize_pose_graph(PoseGraph(*(_t(a) for a in problems[2])), iters=PG_ITERS)
    for res in ranks:
        np.testing.assert_allclose(res["pose_graph"]["R"].numpy(), want.R.numpy(), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(res["pose_graph"]["t"].numpy(), want.t.numpy(), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(res["pose_graph"]["cost_history"].numpy(),
                                   want.cost_history.numpy(), rtol=1e-3, atol=1e-6)


def test_distributed_pose_graph_matches_jax_distributed(eight_devices, problems, ranks):
    want = jdist_pg(jmesh.make_mesh(JMeshConfig(data=8, tile=1)), iters=PG_ITERS)(problems[2])
    np.testing.assert_allclose(ranks[0]["pose_graph"]["R"].numpy(), np.asarray(want.R),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(ranks[0]["pose_graph"]["t"].numpy(), np.asarray(want.t),
                               rtol=0, atol=POSE_ATOL)

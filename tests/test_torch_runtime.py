"""The port's benchmark, evaluation, golden dumps, profiling and weight
files against the JAX package's (CPU).

Tolerances: the evaluation in float32 agrees with the JAX function's EPE
to 1e-3 px per scene and in the mean, and on D1 to 1e-3 (the float32
network agrees to 1e-3 px per pixel, tests/test_torch_model.py).  The
golden dumps of a float32 pair hold the same keys and agree to 1e-3
absolute in every tensor (rtol 1e-3).  The benchmark's dict has the
reference's keys, with the same counts.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.data.loader import SyntheticStereoDataset as JDataset
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.runtime import benchmark as jbench
from hobot_stereonet_tpu.runtime import evaluate as jeval
from hobot_stereonet_tpu.runtime import golden as jgolden
from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.data.loader import SyntheticStereoDataset
from hobot_stereonet_tpu_torch.models import FastStereoNet
from hobot_stereonet_tpu_torch.runtime import benchmark, evaluate, golden
from hobot_stereonet_tpu_torch.runtime.weights import (
    from_flax_params, load_flax_npz, random_flax_params, save_flax_npz, write_npz)
from hobot_stereonet_tpu_torch.utils.profiling import StageTimer, device_trace

torch.set_num_threads(1)

SMALL = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
             aggregation_channels=8, max_disparity=32)


@pytest.fixture(scope="module")
def flagship():
    return jax.tree_util.tree_map(np.asarray, load_params("checkpoints/flagship/params"))


def test_measure_engine_fps_returns_the_reference_dict():
    kw = dict(batch=2, n_batches=2, stage_timing=True, ring_size=3, height=32, width=64)
    got = benchmark.measure_engine_fps(
        model_cfg=tconfig.StereoNetConfig(compute_dtype=torch.float32, **SMALL),
        device="cpu", **kw)
    want = jbench.measure_engine_fps(
        model_cfg=jconfig.StereoNetConfig(compute_dtype=jnp.float32, **SMALL),
        preprocess_cfg=jconfig.PreprocessConfig(color_space="yuv"), **kw)
    assert set(got) == set(want)
    for k in ("frames_in", "frames_out", "nan_dropped", "batch", "dispatch_batch_mean",
              "int8", "geometry"):
        assert got[k] == want[k], k
    assert got["frames_out"] == 4 and got["fps"] > 0 and got["preprocess_ms"] > 0
    q = benchmark.measure_engine_fps(
        model_cfg=tconfig.StereoNetConfig(compute_dtype=torch.float32, **SMALL),
        int8=True, device="cpu", **kw)
    assert q["int8"] is True and q["frames_out"] == 4 and set(q) == set(want)


def test_evaluate_dataset_matches_jax(flagship):
    """Four scenes of 60x120, padded to 64x128 and cropped back, in float32."""
    kw = dict(size=4, seed=777, height=60, width=120)
    yuv = dict(color_space="yuv")
    jcfg = jconfig.Config(model=jconfig.StereoNetConfig(compute_dtype=jnp.float32),
                          preprocess=jconfig.PreprocessConfig(**yuv))
    tcfg = tconfig.Config(model=tconfig.StereoNetConfig(compute_dtype=torch.float32),
                          preprocess=tconfig.PreprocessConfig(**yuv))
    want = jeval.evaluate_dataset(JFastStereoNet(jcfg.model), flagship, JDataset(**kw), jcfg)
    got = evaluate.evaluate_dataset(None, flagship, SyntheticStereoDataset(**kw), tcfg,
                                    device="cpu")
    assert got.n_frames == want.n_frames == 4 and len(got.per_frame_epe) == 4
    np.testing.assert_allclose(got.per_frame_epe, want.per_frame_epe, atol=1e-3)
    assert abs(got.epe - want.epe) <= 1e-3 and abs(got.d1_all - want.d1_all) <= 1e-3
    assert set(got.to_dict()) == set(want.to_dict())
    net = FastStereoNet(tcfg.model, device="cpu")
    net.load_state_dict(from_flax_params(flagship, tcfg.model))
    again = evaluate.evaluate_dataset(net, None, SyntheticStereoDataset(**kw), tcfg, max_frames=2)
    assert again.n_frames == 2
    np.testing.assert_allclose(again.per_frame_epe, got.per_frame_epe[:2], rtol=1e-6)


@pytest.mark.parametrize("scheme", ["dynamic", "static"])
def test_evaluate_dataset_int8_matches_jax(flagship, scheme):
    """The same four scenes evaluated w8a8 (``int8=True``; ``static_quant``
    = the flagship's calibration) in float32: the mean EPE within 0.02 px
    of the JAX function's and each scene's within 0.1 px (measured: means
    -0.0028 and -0.0077 px, per scene at most 0.059 and 0.044 px; why
    int8 spreads further than the float network: tests/test_torch_quant.py)."""
    from hobot_stereonet_tpu.ops import quant as jq
    from hobot_stereonet_tpu_torch.reference import CALIB_JSON

    kw = dict(size=4, seed=777, height=60, width=120)
    yuv = dict(color_space="yuv")
    jcfg = jconfig.Config(model=jconfig.StereoNetConfig(compute_dtype=jnp.float32),
                          preprocess=jconfig.PreprocessConfig(**yuv))
    tcfg = tconfig.Config(model=tconfig.StereoNetConfig(compute_dtype=torch.float32),
                          preprocess=tconfig.PreprocessConfig(**yuv))
    jmodel = JFastStereoNet(jcfg.model)
    if scheme == "static":
        jkw = dict(static_quant=jq.make_static_quant(jmodel, flagship, str(CALIB_JSON), 64, 128))
        tkw = dict(static_quant=str(CALIB_JSON))
    else:
        jkw = tkw = dict(int8=True)
    want = jeval.evaluate_dataset(jmodel, flagship, JDataset(**kw), jcfg, **jkw)
    got = evaluate.evaluate_dataset(None, flagship, SyntheticStereoDataset(**kw), tcfg,
                                    device="cpu", **tkw)
    delta = np.asarray(got.per_frame_epe) - np.asarray(want.per_frame_epe)
    assert got.n_frames == 4 and abs(got.epe - want.epe) <= 0.02 and np.abs(delta).max() <= 0.1


def test_golden_dump_matches_jax_key_by_key(flagship, tmp_path):
    rng = np.random.default_rng(2)
    left = rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    jcfg = jconfig.Config(model=jconfig.StereoNetConfig(compute_dtype=jnp.float32),
                          preprocess=jconfig.PreprocessConfig(color_space="yuv"))
    tcfg = tconfig.Config(model=tconfig.StereoNetConfig(compute_dtype=torch.float32),
                          preprocess=tconfig.PreprocessConfig(color_space="yuv"))
    want = jgolden.dump_pipeline(JFastStereoNet(jcfg.model), flagship, left, right, jcfg)
    got = golden.dump_pipeline(FastStereoNet(tcfg.model, device="cpu"), flagship, left, right,
                               tcfg, path=str(tmp_path / "port.npz"))
    assert set(got) == set(want)
    ok, report = golden.compare(got, want, rtol=1e-3, atol=1e-3)
    assert ok, {k: v for k, v in report.items() if v["status"] != "ok"}
    back = golden.load_dump(str(tmp_path / "port.npz"))
    assert set(back) == set(got)
    bad = dict(got, disparity=got["disparity"] + 1.0)
    ok, report = golden.compare(bad, want)
    assert not ok and report["disparity"]["status"] == "mismatch"
    del bad["confidence"]
    assert golden.compare(bad, want)[1]["confidence"]["status"] == "missing"
    raw = tmp_path / "disparity.bin"
    got["disparity"].tofile(raw)
    ok, report = golden.compare(golden.load_dump(str(raw)), {"disparity": got["disparity"]})
    assert ok and report["disparity"]["flat_compare"]


def test_flax_npz_round_trip_and_determinism(tmp_path):
    tree = random_flax_params(tconfig.StereoNetConfig(**SMALL), seed=3)
    save_flax_npz(tree, str(tmp_path / "a.npz"))
    save_flax_npz(tree, str(tmp_path / "b.npz"))
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()
    back = load_flax_npz(str(tmp_path / "a.npz"))
    la, lb = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    with np.load(tmp_path / "a.npz") as data:
        assert "FeatureTower_0/ConvBlock_0/Conv_0/kernel" in data.files
    write_npz(str(tmp_path / "c.npz"), {"x": np.arange(3), "s": np.array("flag")})
    with np.load(tmp_path / "c.npz") as data:
        assert str(data["s"]) == "flag" and data["x"].tolist() == [0, 1, 2]


def test_stage_timer_and_cpu_device_trace(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("ingest"):
            pass
    assert timer.summary()["ingest"]["count"] == 2
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names or "aten::mm" in names
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

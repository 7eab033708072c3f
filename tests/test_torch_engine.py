"""The port's StereoEngine against the JAX package's, on the CPU.

Same config (the flagship's widths at a 64x128 camera, float32 compute,
batch buckets 1/2/4), same NV12 frames, same flagship weights carried
across.  Tolerances as for the float32 network (tests/test_torch_model.py):
1e-3 px on disparity, 1e-4 relative on depth, 1e-4 on confidence.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.data.stream import Frame as JFrame
from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu.runtime.engine import StereoEngine as JStereoEngine
from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine

torch.set_num_threads(1)

H, W = 64, 128
ENGINE = dict(max_batch=4, batch_buckets=(1, 2, 4))


def _configs():
    jcfg = jconfig.Config(
        camera=jconfig.CameraConfig(width=W, height=H),
        model=jconfig.StereoNetConfig(compute_dtype=jnp.float32),
        preprocess=jconfig.PreprocessConfig(color_space="yuv"),
        engine=jconfig.EngineConfig(**ENGINE),
    )
    tcfg = tconfig.Config(
        camera=tconfig.CameraConfig(width=W, height=H),
        model=tconfig.StereoNetConfig(compute_dtype=torch.float32),
        preprocess=tconfig.PreprocessConfig(color_space="yuv"),
        engine=tconfig.EngineConfig(**ENGINE),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def engines():
    params = jax.tree_util.tree_map(np.asarray, load_params("checkpoints/flagship/params"))
    jcfg, tcfg = _configs()
    return (JStereoEngine(jcfg, params=params, emit_confidence=True),
            StereoEngine(tcfg, params=params, emit_confidence=True, device="cpu"))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (3, 3 * H * W), dtype=np.uint8)


def test_partial_batch_pads_by_repeating_last_frame(engines, frames):
    _, eng = engines
    fs = [Frame(0.0, f, H, 2 * W, index=i) for i, f in enumerate(frames)]
    batch = eng._assemble_batch(fs)
    assert batch.shape == (4, 3 * H * W)
    np.testing.assert_array_equal(batch[:3], frames)
    np.testing.assert_array_equal(batch[3], frames[2])
    assert eng._assemble_batch(fs[:2]).shape[0] == 2


def test_pipeline_matches_jax(engines, frames):
    jeng, eng = engines
    batch = np.concatenate([frames, frames[-1:]])         # bucket 4, padded
    jd, jz, jc, jflags = (np.asarray(a) for a in jeng._pipeline(jeng.params, jnp.asarray(batch)))
    d, z, c, flags = (t.numpy() for t in eng.pipeline(torch.from_numpy(batch)))
    assert d.shape == (4, H, W) and c.shape == (4, H // 8, W // 8)
    np.testing.assert_allclose(d, jd, atol=1e-3)
    np.testing.assert_allclose(z, jz, rtol=1e-4)
    np.testing.assert_allclose(c, jc, atol=1e-4)
    np.testing.assert_array_equal(flags, jflags)
    assert not flags.any()
    # The padded row repeats the last frame's result.
    np.testing.assert_array_equal(d[3], d[2])


def test_stream_matches_jax(engines, frames):
    jeng, eng = engines
    now = time.monotonic()
    jres = jeng.run_stream([JFrame(now, f, H, 2 * W, index=i) for i, f in enumerate(frames)])
    res = eng.run_stream([Frame(now, f, H, 2 * W, index=i) for i, f in enumerate(frames)],
                         timeout=120.0)
    assert sorted(r.index for r in res) == [0, 1, 2]
    jby = {r.index: r for r in jres}
    for r in res:
        j = jby[r.index]
        assert r.disparity.shape == (H, W) and r.disparity.dtype == np.float32
        np.testing.assert_allclose(r.disparity, j.disparity, atol=1e-3)
        np.testing.assert_allclose(r.depth_m, j.depth_m, rtol=1e-4)
        np.testing.assert_allclose(r.confidence, j.confidence, atol=1e-4)
    snap = eng.metrics.snapshot()
    assert snap["frames_out"] >= 3 and snap["nan_dropped"] == 0


def test_feed_rejects_bad_geometry(engines):
    _, eng = engines
    assert eng.feed(Frame(0.0, np.zeros(100, np.uint8), H, 2 * W)) is False
    assert eng.feed(Frame(0.0, np.zeros(3 * H * W, np.float32), H, 2 * W)) is False
    assert eng.feed(Frame(0.0, np.zeros(3 * H * W, np.uint8), H, W)) is False


def _small_engine(**kw):
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg, model=tconfig.StereoNetConfig(
        feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
        aggregation_channels=8, max_disparity=32, compute_dtype=torch.float32))
    return StereoEngine(cfg, device="cpu", **kw)


def test_nan_guard_drops_nonfinite_frames(frames):
    eng = _small_engine()
    with torch.no_grad():
        eng.model.upsample_mask.bias.fill_(float("nan"))
    res = eng.run_stream([Frame(0.0, f, H, 2 * W, index=i) for i, f in enumerate(frames)],
                         timeout=60.0)
    assert res == [] and eng.metrics.nan_dropped == 3


def test_drain_has_a_deadline_and_surfaces_worker_errors(frames):
    eng = _small_engine()
    real = eng._launch

    def slow(batch):
        time.sleep(1.0)
        return real(batch)

    eng._launch = slow
    eng.start(warmup=False)
    try:
        eng.feed(Frame(0.0, frames[0], H, 2 * W))
        with pytest.raises(TimeoutError):
            eng.drain(timeout=0.2)
        eng.drain(timeout=60.0)
    finally:
        eng.stop()

    def broken(batch):
        raise RuntimeError("device fault")

    eng._launch = broken
    eng.start(warmup=False)
    try:
        eng.feed(Frame(0.0, frames[0], H, 2 * W))
        with pytest.raises(RuntimeError, match="worker thread died"):
            eng.drain(timeout=60.0)
    finally:
        eng.stop()


def test_drain_waits_for_a_frame_between_queues(frames):
    eng = _small_engine()
    q = eng._inflight_q
    real_get = q.get

    def slow_get(*args, **kwargs):
        item = real_get(*args, **kwargs)
        time.sleep(0.3)            # the fetch thread holds the batch, no queue does
        return item

    q.get = slow_get
    eng.start(warmup=False)
    try:
        assert eng.feed(Frame(0.0, frames[0], H, 2 * W, index=7))
        eng.drain(timeout=60.0)
        res = eng.poll(timeout=0)
        assert res is not None and res.index == 7
    finally:
        eng.stop()


def test_engine_refuses_what_it_does_not_serve():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        StereoEngine(dataclasses.replace(tcfg, mesh={"data": 2, "tile": 1}), device="cpu")
    with pytest.raises(NotImplementedError):
        StereoEngine(dataclasses.replace(
            tcfg, engine=tconfig.EngineConfig(device_microbatch=4)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StereoEngine(tcfg)

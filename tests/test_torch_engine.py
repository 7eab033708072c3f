"""The port's StereoEngine against the JAX package's, on the CPU.

Same config (the flagship's widths at a 64x128 camera, float32 compute,
batch buckets 1/2/4), same NV12 frames, same flagship weights carried
across.  Tolerances as for the float32 network (tests/test_torch_model.py):
1e-3 px on disparity, 1e-4 relative on depth, 1e-4 on confidence.

The flagship's own bf16 compute is held to the bf16 network's limits of
tests/test_torch_model.py: a median |error| of 0.03 px, a maximum of 1 px,
and 0.03 on confidence.  The ring-fed dispatch, ``fetch_results=False``,
``stage_timing`` and ``device_microbatch`` are the same pipeline fed,
split or returned another way, held at the float32 tolerances above
against the JAX engine run with the same options; within the port, a
microbatched or ring-fed batch equals the plain one exactly on the CPU.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.data import stream as jstream
from hobot_stereonet_tpu.data.stream import Frame as JFrame
from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.runtime.engine import StereoEngine as JStereoEngine
from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.data import stream as tstream
from hobot_stereonet_tpu_torch.reference import CALIB_JSON
from hobot_stereonet_tpu_torch.runtime.engine import DeviceBatchView, Frame, StereoEngine

torch.set_num_threads(1)

H, W = 64, 128
ENGINE = dict(max_batch=4, batch_buckets=(1, 2, 4))


def _configs(bf16: bool = False, **engine):
    jcfg = jconfig.Config(
        camera=jconfig.CameraConfig(width=W, height=H),
        model=jconfig.StereoNetConfig(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32),
        preprocess=jconfig.PreprocessConfig(color_space="yuv"),
        engine=jconfig.EngineConfig(**{**ENGINE, **engine}),
    )
    tcfg = tconfig.Config(
        camera=tconfig.CameraConfig(width=W, height=H),
        model=tconfig.StereoNetConfig(compute_dtype=torch.bfloat16 if bf16 else torch.float32),
        preprocess=tconfig.PreprocessConfig(color_space="yuv"),
        engine=tconfig.EngineConfig(**{**ENGINE, **engine}),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, load_params("checkpoints/flagship/params"))


@pytest.fixture(scope="module")
def engines(params):
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
    """A mesh larger than the process group is refused (one process without a
    group holds one rank; mesh serving: tests/test_torch_mesh_engine.py);
    int8, static scales and the quantized input are served (tests below and
    tests/test_torch_quant.py)."""
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        StereoEngine(dataclasses.replace(tcfg, mesh={"data": 2, "tile": 1}), device="cpu")
    assert StereoEngine(tcfg, int8=True, device="cpu").int8
    eng = StereoEngine(dataclasses.replace(
        tcfg, preprocess=tconfig.PreprocessConfig(color_space="yuv", quantize=True)),
        static_quant=str(CALIB_JSON), device="cpu")
    assert len(eng.static_quant) == 28
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StereoEngine(tcfg)


def test_bf16_engine_matches_jax(params, rings):
    """The flagship config (bf16) on the same frames and weights, against the
    JAX engine as this process runs it (XLA's default excess precision):
    median |error| <= 0.05 px, at most 3 % of pixels off by more than 1 px,
    none by more than 8 px (one coarse candidate); confidence within 0.03.

    At 64x128 a large share of pixels lie near a border or an occlusion,
    where the bf16 soft-argmin is sensitive.  The bound is the reference's
    own spread: on these four frames, JAX with its default rounding
    against JAX under --xla_allow_excess_precision=false (the rounding the
    port follows) differs by a median 0.027 px, 1.6 % of pixels over 1 px
    and at most 2.95 px; the port against the default differs by a median
    0.029 px and at most 2.35 px (measured on the CPU).  The frames are
    procedural scenes: random bytes have no match to find, and there the
    bf16 soft-argmin of either side is noise."""
    jcfg, tcfg = _configs(bf16=True)
    jeng = JStereoEngine(jcfg, params=params, emit_confidence=True)
    eng = StereoEngine(tcfg, params=params, emit_confidence=True, device="cpu")
    batch = rings[1].data[[0, 1, 2, 2]].numpy()
    jd, _, jc, _ = (np.asarray(a) for a in jeng._pipeline(jeng.params, jnp.asarray(batch)))
    d, _, c, flags = (t.numpy() for t in eng.pipeline(torch.from_numpy(batch)))
    err = np.abs(d - jd)
    stats = (float(np.median(err)), float(np.mean(err > 1.0)), float(err.max()))
    assert stats[0] <= 0.05 and stats[1] <= 0.03 and stats[2] <= 8.0, stats
    assert np.abs(c - jc).max() <= 0.03 and not flags.any()


def _bf16_engine_stats(d, jd):
    err = np.abs(d - jd)
    return float(np.median(err)), float(np.mean(err > 1.0)), float(err.max())


def test_default_config_engine_matches_jax(params, rings):
    """F1: ``Config()`` (RGB input, bf16, the flagship's widths) at a 64x128
    camera, against the JAX engine of the same config, on the same frames
    and weights: the bounds of :func:`test_bf16_engine_matches_jax`
    (measured on the CPU: median 0.030 px, 0.36 % of pixels over 1 px, max
    2.22 px).  The RGB ingest itself is bit-equal to JAX's
    (tests/test_torch_ingest_modes.py); in float32 the two engines agree
    to the float32 network's 1e-3 px."""
    camera = dict(width=W, height=H)
    batch = rings[1].data[[0, 1, 2, 2]].numpy()
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jcfg = jconfig.Config(camera=jconfig.CameraConfig(**camera),
                              model=jconfig.StereoNetConfig(compute_dtype=jdt),
                              engine=jconfig.EngineConfig(**ENGINE))
        tcfg = tconfig.Config(camera=tconfig.CameraConfig(**camera),
                              model=tconfig.StereoNetConfig(compute_dtype=dt),
                              engine=tconfig.EngineConfig(**ENGINE))
        assert tcfg.preprocess == tconfig.PreprocessConfig(color_space="rgb")
        jeng = JStereoEngine(jcfg, params=params, emit_confidence=True)
        eng = StereoEngine(tcfg, params=params, emit_confidence=True, device="cpu")
        jd, _, jc, _ = (np.asarray(a) for a in jeng._pipeline(jeng.params, jnp.asarray(batch)))
        d, _, c, flags = (t.numpy() for t in eng.pipeline(torch.from_numpy(batch)))
        assert not flags.any() and d.shape == (4, H, W)
        if dt == torch.float32:
            np.testing.assert_allclose(d, jd, atol=1e-3)
            np.testing.assert_allclose(c, jc, atol=1e-4)
        else:
            stats = _bf16_engine_stats(d, jd)
            assert stats[0] <= 0.05 and stats[1] <= 0.03 and stats[2] <= 8.0, stats
            assert np.abs(c - jc).max() <= 0.03


@pytest.mark.parametrize("scheme", ["dynamic", "static"])
def test_int8_engine_matches_jax(params, rings, scheme):
    """The flagship's bf16 engine run w8a8 (``int8=True``; ``static_quant``
    = the flagship's ``calib.json``), against the JAX engine run the same
    way, on the same frames and weights: median |error| <= 0.06 px, at
    most 3 % of pixels over 1 px, none over 16 px, confidence within 0.05
    (measured on the CPU: dynamic median 0.050 px, 0.96 % over 1 px, max
    4.55 px, confidence 0.026; static 0.020 px, 1.62 %, 7.09 px, 0.030;
    the int8 bounds of tests/test_torch_quant.py, with the 64x128 share
    over 1 px of :func:`test_bf16_engine_matches_jax`).  Within
    the port, the padded row equals the frame it repeats."""
    from hobot_stereonet_tpu.ops import quant as jq

    jcfg, tcfg = _configs(bf16=True)
    if scheme == "static":
        jkw = dict(static_quant=jq.make_static_quant(
            JFastStereoNet(jcfg.model), params, str(CALIB_JSON), H, W))
        tkw = dict(static_quant=str(CALIB_JSON))
    else:
        jkw = tkw = dict(int8=True)
    jeng = JStereoEngine(jcfg, params=params, emit_confidence=True, **jkw)
    eng = StereoEngine(tcfg, params=params, emit_confidence=True, device="cpu", **tkw)
    batch = rings[1].data[[0, 1, 2, 2]].numpy()
    jd, _, jc, _ = (np.asarray(a) for a in jeng._pipeline(jeng.params, jnp.asarray(batch)))
    d, _, c, flags = (t.numpy() for t in eng.pipeline(torch.from_numpy(batch)))
    stats = _bf16_engine_stats(d, jd)
    assert stats[0] <= 0.06 and stats[1] <= 0.03 and stats[2] <= 16.0, stats
    assert np.abs(c - jc).max() <= 0.05 and not flags.any()
    np.testing.assert_array_equal(d[3], d[2])


def _results(res):
    return {r.index: r for r in res}


@pytest.fixture(scope="module")
def rings():
    kw = dict(height=H, width=W, ring_size=3, seed=5)
    return jstream.DeviceFrameRing(**kw), tstream.DeviceFrameRing(**kw, device="cpu")


def test_ring_fed_device_results_and_microbatch_match_jax(params, rings):
    """Ring-fed dispatch, fetch_results=False and device_microbatch=2 against
    the JAX engine with the same options, on 8 frames served as two buckets
    of 4 (each in two chunks)."""
    jring, ring = rings
    opts = dict(fetch_results=False, device_microbatch=2, drop_on_full=False)
    jcfg, tcfg = _configs(**opts)
    jeng = JStereoEngine(jcfg, params=params, emit_confidence=True)
    eng = StereoEngine(tcfg, params=params, emit_confidence=True, device="cpu")
    eng.warmup(buckets=[4], ring=ring)
    assert eng.metrics.dispatch_batch.n == 0
    jres = _results(jeng.run_stream(list(jring.frames(8))))
    fs = list(ring.frames(8))
    assert eng._assemble_batch(fs[:3]) == (ring, [0, 1, 2, 2])
    res = _results(eng.run_stream(fs, timeout=120.0))
    assert sorted(res) == list(range(8))
    for i, r in res.items():
        assert isinstance(r.disparity, DeviceBatchView) and r.disparity.shape == (H, W)
        assert r.disparity.device_array().data_ptr() != 0
        j = jres[i]
        np.testing.assert_allclose(np.asarray(r.disparity), np.asarray(j.disparity), atol=1e-3)
        np.testing.assert_allclose(np.asarray(r.depth_m), np.asarray(j.depth_m), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(r.confidence), np.asarray(j.confidence), atol=1e-4)
    # Within the port: chunks of 2 and the ring gather equal one plain batch.
    plain = StereoEngine(_configs()[1], params=params, emit_confidence=True, device="cpu")
    whole = plain.pipeline(ring.data[[0, 1, 2, 0]])
    chunked = eng.pipeline(ring.data[[0, 1, 2, 0]])
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(res[3].disparity), whole[0][3].numpy())


def test_stage_timing_and_keep_left_match_jax(params, engines, rings):
    jring, ring = rings
    jeng, _ = engines
    _, tcfg = _configs(stage_timing=True, drop_on_full=False)
    eng = StereoEngine(tcfg, params=params, emit_confidence=True, keep_left=True, device="cpu")
    eng.warmup(buckets=[1], ring=ring)
    assert eng.metrics.preprocess_latency.summary()["n"] == 0
    fs = list(ring.frames(3))
    res = _results(eng.run_stream(fs, timeout=120.0))
    snap = eng.metrics.snapshot()
    n = eng.metrics.dispatch_batch.n
    assert snap["preprocess_latency"]["n"] == snap["network_latency"]["n"] == n >= 1
    want = [np.asarray(a) for a in jeng._pipeline(jeng.params, jring.data[jnp.asarray([0, 1, 2])])]
    for i, r in res.items():
        np.testing.assert_allclose(r.disparity, want[0][i], atol=1e-3)
        np.testing.assert_allclose(r.confidence, want[2][i], atol=1e-4)
        np.testing.assert_array_equal(r.left_rgb, jstream.sbs_nv12_to_left_rgb(
            np.asarray(jring.data[i]), H, 2 * W))
        assert r.left_rgb.shape == (H, W, 3) and r.left_rgb.dtype == np.uint8


def test_synchronous_api_matches_jax(engines):
    jeng, eng = engines
    rng = np.random.default_rng(11)
    left = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    d = eng.infer(left, right)
    assert d.shape == (H, W) and d.dtype == np.float32
    np.testing.assert_allclose(d, jeng.infer(left, right), atol=1e-3)
    d2, c2 = eng.infer_with_confidence(left, right)
    jd2, jc2 = jeng.infer_with_confidence(left, right)
    np.testing.assert_array_equal(d2, d)
    assert c2.shape == (H // 8, W // 8)
    np.testing.assert_allclose(c2, jc2, atol=1e-4)
    from hobot_stereonet_tpu_torch.ops.preprocess import rgb_pair_to_model_input

    x = rgb_pair_to_model_input(left, right, eng.cfg.preprocess, "cpu")
    np.testing.assert_array_equal(eng.infer_preprocessed(x), d)

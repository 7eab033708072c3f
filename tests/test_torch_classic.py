"""The port's CLASSIC StereoNet and its modules against the JAX package's,
on the CPU, on the same seeded numpy inputs and weights (flax's own
initialization, carried across with ``runtime/weights.py``).

Tolerances:
  * float32 modules: the two frameworks sum conv products in other orders,
    so a block agrees to float32 rounding grown through its layers, 1e-4
    (a dilated ResBlock2D, a ConvBlock3D, a RefinementNet and a
    CostAggregation alike); the fixed stencils (cost volume, 2x bilinear,
    average pooling) and the soft-argmin to 1e-6 (the same float32
    operations, in the reference's order, up to a fused multiply-add).
  * The small StereoNet in float32: disparity 1e-3 px, confidence 1e-4, as
    the flagship's network (tests/test_torch_model.py).
  * The small StereoNet in bf16 against JAX with its default rounding
    (XLA keeps bf16 values in float32 inside a fusion): both round each
    conv's output to bf16, but not at all the same points, and the soft
    argmin, the bilinear upsampling and three refinements carry a coarse
    difference to every fine pixel: median |error| <= 0.03 px and max
    <= 1 px, confidence within 0.03, the flagship's bounds (measured on
    the CPU: StereoNet median 0.0051 px, max 0.060 px, confidence equal;
    FastStereoNet with ``upsample_mode="refine"`` median 0.0144 px, max
    0.143 px, confidence 0.0051).
  * The engine: float32, held to the network's float32 tolerances against
    the JAX engine serving ``StereoNet``; within the port, streamed results
    equal one synchronous call exactly.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.config import StereoNetConfig as JStereoNetConfig
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.models import StereoNet as JStereoNet
from hobot_stereonet_tpu.models.layers import ConvBlock3D as JConvBlock3D
from hobot_stereonet_tpu.models.layers import ResBlock2D as JResBlock2D
from hobot_stereonet_tpu.models.stereonet import CostAggregation as JCostAggregation
from hobot_stereonet_tpu.models.stereonet import RefinementNet as JRefinementNet
from hobot_stereonet_tpu.ops import cost_volume as jcv
from hobot_stereonet_tpu.ops import soft_argmin as jsa
from hobot_stereonet_tpu.ops import upsample as jup
from hobot_stereonet_tpu.runtime.engine import StereoEngine as JStereoEngine
from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.config import StereoNetConfig
from hobot_stereonet_tpu_torch.models import FastStereoNet, StereoNet
from hobot_stereonet_tpu_torch.models.layers import ConvBlock3D, ResBlock2D, cast_convs
from hobot_stereonet_tpu_torch.models.stereonet import CostAggregation, RefinementNet
from hobot_stereonet_tpu_torch.ops import cost_volume as tcv
from hobot_stereonet_tpu_torch.ops import upsample as tup
from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc
from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine
from hobot_stereonet_tpu_torch.runtime.weights import flax_to_state_dict, from_flax_params

torch.set_num_threads(1)

# A CLASSIC StereoNet cut to a test's size: 1/4 resolution (two refinement
# scales), 8 channels, one 3-D aggregation layer, D = 4.
SMALL = dict(downsample_factor=2, feature_channels=8, num_feature_res_blocks=1,
             num_aggregation_layers=1, aggregation_channels=8, max_disparity=16,
             refinement_scale_channels=(8, 4), refinement_scale_blocks=(2, 1))


def _cf(x: np.ndarray) -> torch.Tensor:
    """[N, *spatial, C] numpy -> N C *spatial tensor (channel-last memory)."""
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def _cl(t: torch.Tensor) -> np.ndarray:
    return t.detach().movedim(1, -1).numpy()


def _init(jmod, *args):
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("dhw", [(4, 6, 10), (5, 7, 9)])
def test_conv_block_3d(rng, dhw):
    x = rng.standard_normal((2, *dhw, 8)).astype(np.float32)
    jmod = JConvBlock3D(16, dtype=jnp.float32)
    variables = _init(jmod, x)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = ConvBlock3D(8, 16)
    mod.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = _cl(mod(_cf(x)))
    assert got.shape == want.shape == (2, *dhw, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(20, 28), (19, 27)])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_dilated_res_block(rng, dilation, hw):
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    jmod = JResBlock2D(8, dilation=dilation, dtype=jnp.float32)
    variables = _init(jmod, x)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = ResBlock2D(8, dilation=dilation)
    mod.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = _cl(mod(_cf(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["difference", "concat"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_build_cost_volume(rng, mode, dtype):
    fl = jnp.asarray(rng.standard_normal((2, 5, 9, 4)), dtype)
    fr = jnp.asarray(rng.standard_normal((2, 5, 9, 4)), dtype)
    want = np.asarray(jcv.build_cost_volume(fl, fr, 11, mode).astype(jnp.float32))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (fl, fr)]
    got = tcv.build_cost_volume(*t, 11, mode)
    assert got.dtype == tdt and got.is_contiguous()
    assert got.shape == want.shape == (2, 11, 5, 9, 4 if mode == "difference" else 8)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(tcv.shift_right_features(t[1], 3).float().numpy(),
                                  np.asarray(jcv.shift_right_features(fr, 3).astype(jnp.float32)))
    with pytest.raises(ValueError, match="mode"):
        tcv.build_cost_volume(*t, 3, "sum")


@pytest.mark.parametrize("hw", [(5, 7), (8, 12)])
def test_upsample_and_downsample(rng, hw):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    np.testing.assert_allclose(tup.upsample2x_bilinear(torch.from_numpy(x)).numpy(),
                               np.asarray(jup.upsample2x_bilinear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    big = rng.standard_normal((2, 4 * hw[0], 4 * hw[1], 3)).astype(np.float32)
    for f in (1, 2, 4):
        np.testing.assert_array_equal(tup.downsample_avg(torch.from_numpy(big), f).numpy(),
                                      np.asarray(jup.downsample_avg(jnp.asarray(big), f)))
    h, w = 4 * hw[0], 4 * hw[1]
    got = tup.upsample_bilinear(torch.from_numpy(x), h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(jup.upsample_bilinear(jnp.asarray(x), h, w)),
                               rtol=1e-6, atol=1e-6)
    # Other factors follow jax.image.resize (ROADMAP A6; more factors in
    # tests/test_torch_parallel.py).
    got = tup.upsample_bilinear(torch.from_numpy(x), 3 * hw[0], 3 * hw[1])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jup.upsample_bilinear(jnp.asarray(x), 3 * hw[0], 3 * hw[1])),
        rtol=1e-6, atol=1e-6)


def test_upsample2x_matches_jax_image_resize(rng):
    """The stencil is the half-pixel bilinear resize it replaces."""
    x = rng.standard_normal((1, 6, 10, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 12, 20, 2), "bilinear"))
    np.testing.assert_allclose(tup.upsample2x_bilinear(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks", [3, 7])
def test_refinement_net(rng, blocks):
    """Dilations 1, 2, 4, 8, 1, 1 and again from the seventh block."""
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32)
    disp = (8 * rng.random((2, 24, 40, 1))).astype(np.float32)
    guide = rng.uniform(-1, 1, (2, 24, 40, 3)).astype(np.float32)
    jmod = JRefinementNet(jcfg, channels=8, blocks=blocks)
    variables = _init(jmod, disp, guide)
    want = np.asarray(jmod.apply(variables, jnp.asarray(disp), jnp.asarray(guide)))
    mod = RefinementNet(StereoNetConfig(compute_dtype=torch.float32), channels=8, blocks=blocks)
    mod.load_state_dict(flax_to_state_dict(variables))
    assert [getattr(mod, f"ResBlock2D_{i}").Conv_0.dilation[0] for i in range(blocks)] == \
        [1, 2, 4, 8, 1, 1, 1][:blocks]
    with torch.no_grad():
        got = mod(torch.from_numpy(disp[..., 0]), torch.from_numpy(guide))
    np.testing.assert_allclose(got.numpy(), want[..., 0], rtol=1e-4, atol=1e-4)
    assert (got >= 0).all()


def test_cost_aggregation(rng):
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32, aggregation_channels=8,
                            num_aggregation_layers=2)
    vol = rng.standard_normal((2, 6, 5, 9, 8)).astype(np.float32)
    jmod = JCostAggregation(jcfg)
    variables = _init(jmod, vol)
    want = np.asarray(jmod.apply(variables, jnp.asarray(vol)))
    mod = CostAggregation(StereoNetConfig(compute_dtype=torch.float32, aggregation_channels=8,
                                          num_aggregation_layers=2, feature_channels=8))
    mod.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = mod(torch.from_numpy(vol))
    assert got.shape == want.shape == (2, 6, 5, 9) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_soft_argmin_of_a_d_leading_cost(rng, dtype):
    cost = jnp.asarray(3.0 * rng.standard_normal((2, 24, 5, 7)), dtype)
    t = torch.from_numpy(np.array(cost.astype(jnp.float32)))
    t = t if dtype is np.float32 else t.bfloat16()
    disp, conf = kc.soft_argmin_cost(t, scale=8.0)
    assert disp.shape == conf.shape == (2, 5, 7) and disp.dtype == torch.float32
    np.testing.assert_allclose(disp.numpy(), 8.0 * np.asarray(jsa.soft_argmin(cost)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jsa.disparity_confidence(cost)),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="cost"):
        kc.soft_argmin_cost(t[0])


def _inputs(rng, b=2, h=32, w=64):
    left = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.standard_normal(left.shape).astype(np.float32)
    return left, right


def _pair(jmodel_cls, tmodel_cls, name, dtype, left, right, **cfg):
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32, **cfg)
    params = _init(jmodel_cls(jcfg), left, right)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout = jax.jit(jmodel_cls(dataclasses.replace(jcfg, compute_dtype=jdt)).apply)(
        params, jnp.asarray(left), jnp.asarray(right))
    tcfg = StereoNetConfig(compute_dtype=dtype, **cfg)
    net = tmodel_cls(tcfg, device="cpu")
    net.load_state_dict(from_flax_params(params, tcfg, name))
    with torch.inference_mode():
        out = cast_convs(net, dtype).eval()(torch.from_numpy(left), torch.from_numpy(right))
    return out, jout


def _agree(out, jout, dtype):
    d, jd = out["disparity"].numpy(), np.asarray(jout["disparity"])
    assert out["disparity"].dtype == torch.float32 and d.shape == jd.shape
    assert len(out["pyramid"]) == len(jout["pyramid"])
    if dtype == torch.float32:
        np.testing.assert_allclose(d, jd, atol=1e-3)
        np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]),
                                   atol=1e-4)
        for a, b in zip(out["pyramid"], jout["pyramid"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    else:
        err = np.abs(d - jd)
        assert np.median(err) <= 0.03 and err.max() <= 1.0, (np.median(err), err.max())
        conf = np.abs(out["confidence"].numpy() - np.asarray(jout["confidence"]))
        assert conf.max() <= 0.03, conf.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_stereonet_matches_jax(rng, dtype):
    left, right = _inputs(rng)
    out, jout = _pair(JStereoNet, StereoNet, "classic", dtype, left, right, **SMALL)
    assert out["disparity"].shape == (2, 32, 64) and out["confidence"].shape == (2, 8, 16)
    assert [p.shape[1:] for p in out["pyramid"]] == [(8, 16), (16, 32), (32, 64)]
    _agree(out, jout, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_stereonet_refine_mode_matches_jax(rng, dtype):
    left, right = _inputs(rng, h=64, w=128)
    cfg = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
               aggregation_channels=8, max_disparity=32, upsample_mode="refine",
               refinement_scale_channels=(8, 4, 4), refinement_scale_blocks=(2, 1, 1))
    out, jout = _pair(JFastStereoNet, FastStereoNet, "fast", dtype, left, right, **cfg)
    assert len(out["pyramid"]) == 4
    _agree(out, jout, dtype)


def test_models_refuse_what_they_do_not_serve():
    with pytest.raises(ValueError, match="upsample_mode"):
        FastStereoNet(StereoNetConfig(upsample_mode="bilinear"), device="cpu")
    from hobot_stereonet_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="unknown model"):
        build_model("gcnet", StereoNetConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StereoNet(StereoNetConfig(**SMALL))


H, W = 32, 64
ENGINE = dict(max_batch=4, batch_buckets=(1, 2, 4))


def _engine_configs(**engine):
    jcfg = jconfig.Config(camera=jconfig.CameraConfig(width=W, height=H),
                          model=JStereoNetConfig(compute_dtype=jnp.float32, **SMALL),
                          engine=jconfig.EngineConfig(**{**ENGINE, **engine}))
    tcfg = tconfig.Config(camera=tconfig.CameraConfig(width=W, height=H),
                          model=StereoNetConfig(compute_dtype=torch.float32, **SMALL),
                          engine=tconfig.EngineConfig(**{**ENGINE, **engine}))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def classic_params():
    jcfg, _ = _engine_configs()
    x = np.zeros((1, H, W, 3), np.float32)
    return _init(JStereoNet(jcfg.model), x, x)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (3, 3 * H * W), dtype=np.uint8)


def test_classic_engine_matches_jax_and_streams_as_one_call(classic_params, frames):
    jcfg, tcfg = _engine_configs()
    jeng = JStereoEngine(jcfg, model=JStereoNet(jcfg.model), params=classic_params,
                         emit_confidence=True)
    eng = StereoEngine(tcfg, params=classic_params, emit_confidence=True, device="cpu",
                       model="classic")
    assert isinstance(eng.model, StereoNet)
    batch = np.concatenate([frames, frames[-1:]])
    jd, _, jc, _ = (np.asarray(a) for a in jeng._pipeline(jeng.params, jnp.asarray(batch)))
    d, _, c, flags = (t.numpy() for t in eng.pipeline(torch.from_numpy(batch)))
    np.testing.assert_allclose(d, jd, atol=1e-3)
    np.testing.assert_allclose(c, jc, atol=1e-4)
    assert not flags.any()
    res = eng.run_stream([Frame(time.monotonic(), f, H, 2 * W, index=i)
                          for i, f in enumerate(frames)], timeout=60.0)
    sync = [t.numpy() for t in eng.pipeline(torch.from_numpy(frames))[:3:2]]
    assert sorted(r.index for r in res) == [0, 1, 2]
    for r in res:
        np.testing.assert_array_equal(r.disparity, sync[0][r.index])
        np.testing.assert_array_equal(r.confidence, sync[1][r.index])


def test_classic_engine_microbatch_and_built_model(classic_params, frames):
    """device_microbatch splits a batch of 4 into chunks of 2, exactly as
    the whole batch on the CPU; a built network serves as it is."""
    _, tcfg = _engine_configs(device_microbatch=2)
    eng = StereoEngine(tcfg, params=classic_params, device="cpu", model="classic")
    batch = torch.from_numpy(np.concatenate([frames, frames[:1]]))
    with torch.inference_mode():
        whole = eng._network(eng._ingest(batch))[0]
    np.testing.assert_array_equal(eng.pipeline(batch)[0].numpy(), whole.numpy())
    built = StereoEngine(tcfg, device="cpu", model=eng.model)
    assert built.model is eng.model


def test_classic_int8_engine_builds_and_serves(classic_params, frames):
    """CLASSIC in int8 is no longer refused: its 3-D, dilated, Cout 1 and
    Cout 12 convs are quantized too (``ops/quant.py``, tests/test_torch_classic_int8.py).
    The engine builds in both schemes with every conv swapped and serves
    finite disparities equal to its own int8 network's forward."""
    from hobot_stereonet_tpu_torch.ops.quant import Int8Conv

    _, tcfg = _engine_configs()
    batch = torch.from_numpy(frames[:1])
    for kw in (dict(int8=True), dict(static_quant={})):
        eng = StereoEngine(tcfg, params=classic_params, device="cpu", model="classic", **kw)
        convs = [m for m in eng.model.modules() if isinstance(m, Int8Conv)]
        assert len(convs) == 17 and not any(
            isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) for m in eng.model.modules())
        disp = eng.pipeline(batch)[0]
        assert torch.isfinite(disp).all()
        with torch.inference_mode():
            want = eng._network(eng._ingest(batch))[0]
        assert torch.equal(disp, want)


def test_classic_evaluation_and_benchmark_surface(classic_params):
    from hobot_stereonet_tpu.data.loader import SyntheticStereoDataset as JDataset
    from hobot_stereonet_tpu.runtime.evaluate import evaluate_dataset as jevaluate
    from hobot_stereonet_tpu_torch.data.loader import SyntheticStereoDataset
    from hobot_stereonet_tpu_torch.runtime.benchmark import measure_engine_fps
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset

    jcfg, tcfg = _engine_configs()
    ds = dict(size=2, seed=5, height=H, width=W)
    want = jevaluate(JStereoNet(jcfg.model), classic_params, JDataset(**ds), jcfg)
    got = evaluate_dataset("classic", classic_params, SyntheticStereoDataset(**ds), tcfg,
                           device="cpu")
    np.testing.assert_allclose(got.per_frame_epe, want.per_frame_epe, atol=1e-3)
    out = measure_engine_fps(model="classic", params=classic_params, model_cfg=tcfg.model,
                             batch=2, n_batches=1, ring_size=2, height=H, width=W,
                             device="cpu")
    assert out["frames_out"] == 2 and out["nan_dropped"] == 0

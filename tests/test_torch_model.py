"""The port's network against the JAX package's, with weights carried across.

Tolerances:
  * Blocks and the whole network in float32: the two frameworks sum conv
    products in other orders, so outputs agree to float32 rounding grown
    through the layers: 1e-4 for single blocks, 1e-3 px for the network's
    disparity and 1e-4 for its confidence.
  * The whole network in bfloat16: both round activations to bf16 at the
    same points (the correlation volume and the convex mask's softmax
    included), but cuDNN/oneDNN and XLA accumulate conv products
    differently, so single activations can differ by a bf16 ulp, and the
    x8 convex upsample carries a coarse difference to a fine pixel near an
    edge.  The final disparity must agree to a median |error| of 0.03 px
    and a maximum of 1 px (measured 0.017 and 0.81 px on the CPU), the
    confidence to 0.03 (measured 0.012).
  * ``convex_upsample`` with a bf16 mask: its softmax rounds where
    ``jax.nn.softmax`` does, so the weights are equal and the f32 weighted
    sum agrees to f32 rounding (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import StereoNetConfig as JStereoNetConfig
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.models.layers import ConvBlock as JConvBlock
from hobot_stereonet_tpu.models.layers import ResBlock2D as JResBlock2D
from hobot_stereonet_tpu.models.stereonet import FeatureTower as JFeatureTower
from hobot_stereonet_tpu.ops.upsample import convex_upsample as j_convex_upsample
from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu_torch.config import StereoNetConfig
from hobot_stereonet_tpu_torch.models import FastStereoNet, FeatureTower
from hobot_stereonet_tpu_torch.models.layers import ConvBlock, ResBlock2D, cast_convs
from hobot_stereonet_tpu_torch.ops.upsample import convex_upsample
from hobot_stereonet_tpu_torch.runtime.weights import flax_to_state_dict, from_flax_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    return jax.tree_util.tree_map(np.asarray, load_params("checkpoints/flagship/params"))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _run_block(jmod, tmod, x, seed=0):
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmod.load_state_dict(flax_to_state_dict(variables))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    return got, want


@pytest.mark.parametrize("hw", [(16, 24), (15, 23)])
def test_conv_block_5x5_stride2_same_padding(rng, hw):
    """flax "SAME" pads (1, 2) for 5x5 stride 2 on an even size; odd sizes too."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    got, want = _run_block(
        JConvBlock(8, kernel=(5, 5), strides=(2, 2), dtype=jnp.float32),
        ConvBlock(3, 8, kernel=5, stride=2), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_symmetric_padding_would_shift_the_output(rng):
    """The trap: nn.Conv2d(padding=2) has the right shape but another output."""
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    block = ConvBlock(3, 8, kernel=5, stride=2)
    got, want = _run_block(JConvBlock(8, kernel=(5, 5), strides=(2, 2), dtype=jnp.float32),
                           block, x)
    conv = block.Conv_0
    with torch.no_grad():
        naive = torch.nn.functional.conv2d(_nchw(x), conv.weight, conv.bias, 2, 2)
    assert naive.shape[2:] == (8, 8)
    assert not np.allclose(_nhwc(block.GroupNorm_0(naive)), want, atol=1e-2)


def test_res_block(rng):
    x = rng.standard_normal((2, 12, 20, 16)).astype(np.float32)
    got, want = _run_block(JResBlock2D(16, dtype=jnp.float32), ResBlock2D(16), x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_feature_tower_with_flagship_weights(rng, flagship):
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32)
    variables = {"params": flagship["params"]["FeatureTower_0"]}
    x = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JFeatureTower(jcfg).apply)(variables, jnp.asarray(x)))
    tower = FeatureTower(StereoNetConfig(compute_dtype=torch.float32))
    tower.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = _nhwc(tower(_nchw(x)))
    assert got.shape == want.shape == (2, 4, 8, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(5, 7), (23, 29)])
@pytest.mark.parametrize("mask_dtype", [np.float32, jnp.bfloat16])
def test_convex_upsample(rng, mask_dtype, hw):
    (b, k), (h, w) = (2, 8), hw
    disp = (10 * rng.random((b, h, w))).astype(np.float32)
    mask = rng.standard_normal((b, h, w, 9 * k * k)).astype(np.float32)
    jmask = jnp.asarray(mask).astype(mask_dtype)
    want = np.asarray(j_convex_upsample(jnp.asarray(disp), jmask, k))
    tmask = torch.from_numpy(np.array(jmask.astype(jnp.float32)))
    if mask_dtype is not np.float32:
        tmask = tmask.bfloat16()
    got = convex_upsample(torch.from_numpy(disp), tmask, k).numpy()
    assert got.shape == (b, h * k, w * k) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _inputs(rng, b=2, h=64, w=128):
    left = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=2) + 0.05 * rng.standard_normal(left.shape).astype(np.float32)
    return left, right


def _port_net(params, dtype):
    cfg = StereoNetConfig(compute_dtype=dtype)
    net = FastStereoNet(cfg, device="cpu")
    net.load_state_dict(from_flax_params(params, cfg))
    return cast_convs(net, dtype).eval()


def test_fast_stereonet_is_built_on_the_device_it_is_given():
    cfg = StereoNetConfig(feature_channels=8, num_feature_res_blocks=1,
                          num_aggregation_layers=1, aggregation_channels=8)
    net = FastStereoNet(cfg, device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    assert net.upsample_mask.weight.is_contiguous(memory_format=torch.channels_last)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FastStereoNet(cfg)


def test_fast_stereonet_f32_matches_jax(rng, flagship):
    left, right = _inputs(rng)
    jout = jax.jit(JFastStereoNet(JStereoNetConfig(compute_dtype=jnp.float32)).apply)(
        flagship, jnp.asarray(left), jnp.asarray(right))
    with torch.inference_mode():
        out = _port_net(flagship, torch.float32)(torch.from_numpy(left), torch.from_numpy(right))
    assert out["disparity"].shape == (2, 64, 128) and out["confidence"].shape == (2, 8, 16)
    np.testing.assert_allclose(out["disparity"].numpy(), np.asarray(jout["disparity"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_allclose(out["pyramid"][0].numpy(), np.asarray(jout["pyramid"][0]), atol=1e-3)


def test_fast_stereonet_bf16_matches_jax_in_px(rng, flagship):
    left, right = _inputs(rng)
    jout = jax.jit(JFastStereoNet(JStereoNetConfig()).apply)(
        flagship, jnp.asarray(left), jnp.asarray(right))
    with torch.inference_mode():
        out = _port_net(flagship, torch.bfloat16)(torch.from_numpy(left), torch.from_numpy(right))
    err = np.abs(out["disparity"].numpy() - np.asarray(jout["disparity"]))
    assert out["disparity"].dtype == torch.float32
    assert np.median(err) <= 0.03 and err.max() <= 1.0, (np.median(err), err.max())
    conf_err = np.abs(out["confidence"].numpy() - np.asarray(jout["confidence"]))
    assert conf_err.max() <= 0.03, conf_err.max()


def test_groupnorm_does_not_depend_on_the_batch():
    """A frame's GroupNorm output is the same alone, in a chunk or in the
    whole batch: each (sample, group) is reduced on its own."""
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    torch.manual_seed(0)
    gn = GroupNorm(32)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.uniform_(-0.5, 0.5)
    x = (torch.randn(8, 32, 24, 40) * 3 + 5).bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        whole = gn(x)
        assert torch.equal(whole, torch.cat([gn(x[i:i + 1]) for i in range(8)]))
        assert torch.equal(whole, torch.cat([gn(x[:4]), gn(x[4:])]))
    assert whole.dtype == torch.bfloat16
